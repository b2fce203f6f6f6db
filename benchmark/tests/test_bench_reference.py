"""The plain reference against values worked by hand at toy sizes: the
exact negacyclic product, one keyswitch, one blind rotation, one
whitepaper transfer; and its keys against the program's from one seed."""

import dataclasses

import torch

from benchmark.reference import erc20
from benchmark.reference import tfhe as rt

TOY = rt.Params(lwe_dimension=4, glwe_dimension=1, polynomial_size=8, lwe_noise_log2=None,
                glwe_noise_log2=None, pbs_base_log=8, pbs_level=1, ks_base_log=4, ks_level=3,
                message_modulus=2, carry_modulus=2)


def _negacyclic(a, b):
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            out[k % n] += a[i] * b[j] * (-1 if k >= n else 1)
    return [((x + 2**63) % 2**64) - 2**63 for x in out]


def test_conv_small_is_the_negacyclic_product_mod_2_64():
    g = torch.Generator().manual_seed(1)
    small = torch.randint(-(2**22), 2**22, (3, 2, 16), generator=g)
    polys = torch.randint(-(2**63), 2**63 - 1, (2, 3, 16), generator=g)
    got = rt.conv_small(small, polys)
    for b in range(3):
        for c in range(3):
            want = [0] * 16
            for d in range(2):
                term = _negacyclic(small[b, d].tolist(), polys[d, c].tolist())
                want = [((x + y + 2**63) % 2**64) - 2**63 for x, y in zip(want, term)]
            assert got[b, c].tolist() == want
    # (1 + X) * X^7 = X^7 - 1 in Z[X]/(X^8 + 1)
    x7 = torch.zeros(1, 1, 8, dtype=torch.int64)
    x7[0, 0, 7] = 1
    one_x = torch.zeros(1, 1, 8, dtype=torch.int64)
    one_x[0, 0, :2] = 1
    assert rt.conv_small(one_x, x7)[0, 0].tolist() == [-1, 0, 0, 0, 0, 0, 0, 1]


def test_keyswitch_by_hand():
    """Big key (1, 0, ..., 0) over N = 8, small key (1, 1, 0, 0), noiseless:
    the KSK row of the big key's bit i at level l encrypts s_i * 2^(64-4(l+1))
    with a zero mask here, so the keyswitch of (a, b) is (0, b - round(a_0))."""
    p = dataclasses.replace(TOY)
    n_big, n = p.big_n, p.lwe_dimension
    big = torch.zeros(n_big, dtype=torch.int64)
    big[0] = 1
    ksk = torch.zeros(n_big, p.ks_level, n + 1, dtype=torch.int64)
    for lvl in range(p.ks_level):
        ksk[0, lvl, -1] = 1 << (64 - p.ks_base_log * (lvl + 1))
    keys = rt.Keys(glwe_sk=big[None], lwe_sk=torch.tensor([1, 1, 0, 0]), bsk=None, ksk=ksk)
    a0 = (5 << 60) + (3 << 56) + (9 << 52) + (1 << 47)  # three digits 5, 3, 9 and a part below them
    ct = torch.zeros(1, n_big + 1, dtype=torch.int64)
    ct[0, 0] = a0
    ct[0, -1] = 12345 << 40
    out = rt.keyswitch(p, keys, ct)
    assert out[0, :-1].tolist() == [0] * n
    assert out[0, -1].item() == (12345 << 40) - ((5 << 60) + (3 << 56) + (9 << 52))
    assert rt.phase(keys.lwe_sk, out).item() == rt.phase(big, ct).item() + (1 << 47)


def test_blind_rotation_by_hand():
    """Noiseless keys; a trivial input of message m keyswitches to (0, m D)
    and every step's exponent is 0. Classic: each step adds (X^0 - 1) * EP =
    0, so the output is the trivial LWE of f(m) D. Multi-bit: each group
    replaces acc by EP(sum_v GGSW_v) = EP(GGSW(1)), a fresh mask over the
    same phase; with a gadget of 4 x 16 bits the decomposition is exact, so
    the phase is f(m) D exactly."""
    for g in (None, 2):
        p = dataclasses.replace(TOY, grouping_factor=g, pbs_base_log=16, pbs_level=4)
        keys = rt.keygen(p, seed=99, device="cpu")
        table = [3, 0, 2, 1]
        lut = rt.lut_poly(p, table, "cpu")
        for m in range(4):
            ct = torch.zeros(1, p.big_n + 1, dtype=torch.int64)
            ct[0, -1] = m * p.delta
            out = rt.pbs(p, keys, ct, lut[None])
            assert rt.phase(keys.big_sk, out).item() == table[m] * p.delta
            if g is None:
                assert out[0, :-1].abs().sum().item() == 0


def test_whitepaper_transfer_by_hand():
    bal = [10, 5, 2]
    erc20.transfer(bal, 0, 1, 3, 64)
    assert bal == [7, 8, 2]
    erc20.transfer(bal, 2, 0, 3, 64)  # overdraws: nothing moves
    assert bal == [7, 8, 2]
    erc20.transfer(bal, 1, 2, 8, 64)  # the whole balance
    assert bal == [7, 0, 10]


def test_reference_keys_and_pbs_match_the_program(tmp_path):
    """The keys the reference works out from a seed are the program's, and
    its full-precision PBS lies within the key's rounding of the program's."""
    import numpy as np

    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.models import shortint as si

    from benchmark import system
    from benchmark.tests.conftest import DATA
    import json

    for name in ("toy_c22", "toy_g3"):
        cfg = json.loads((DATA / f"{name}.json").read_text())
        prog, p = system.program_params(cfg), rt.Params.from_config(cfg)
        seed = 2**31 + 77
        ck, sk = si.keygen(prog, seed=seed, device="cpu")
        keys = rt.keygen(p, seed, "cpu")
        assert torch.equal(keys.glwe_sk, ck.glwe_key.key) and torch.equal(keys.lwe_sk, ck.lwe_key.key)
        assert torch.equal(keys.ksk, sk.ksk.ksk)
        gen = torch.Generator().manual_seed(seed)
        m = torch.randint(0, 4, (8,), generator=gen)
        ct = rt.encrypt_big(keys.big_sk, m * p.delta, gen, p.glwe_noise_log2)
        table = [2, 3, 0, 1] * 4
        out = si.apply_lut(sk, si.Ciphertext(ct=ct, params=prog, degree=3, noise_level=1),
                           si.generate_lut(prog, np.array(table, dtype=np.uint64), device="cpu"), 3).ct
        ref = rt.pbs(p, keys, ct, rt.lut_poly(p, table, "cpu").expand(8, -1, -1))
        gap = rt.centered(rt.phase(keys.big_sk, out) - rt.phase(keys.big_sk, ref)).max().item()
        assert 0 < gap < 2**50
        assert rt.decode(p, rt.phase(keys.big_sk, ref), 16).tolist() == [table[v] for v in m.tolist()]
        assert tp.ShortintParams  # the program's parameter type built the set

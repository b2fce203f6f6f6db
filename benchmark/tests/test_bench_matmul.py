"""The matmul cell's yardstick: the plain reference (`reference/glwe_matmul`)
against values worked by brute force at tiny sizes, its keys and products
against the program's at `TOY_MATMUL` on the CPU, the configuration's
numbers against the program's parameter set, and the frozen roofline
counts at one toy shape. On the card (`-m card`), the program at the cell's
own size over a dozen seeds, each printing its readings as a JSON line
(`-s` shows them)."""

import json
import time

import pytest
import torch

from benchmark import harness, roofline, system
from benchmark.reference import glwe_matmul as rm
from benchmark.reference import tfhe as rt
from benchmark.tests.conftest import DATA, MATMUL_LIMITS, ROOT, toy_cell

TOY = rm.Params(glwe_dimension=1, polynomial_size=16, glwe_noise_log2=2, bits_reserved_for_computation=12,
                packing_ks_base_log=8, packing_ks_level=3, packing_ks_noise_log2=2, ct_modulus_out_bits=30)
SEEDS = tuple(2**31 + 1009 * i for i in range(1, 13))


def _wrap(x: int) -> int:
    return ((x + 2**63) % 2**64) - 2**63


def test_extracted_products_by_brute_force():
    """The dot product's LWE is sum_c w[c, o] times the LWE extracted at
    coefficient c: mask index i reads A[c - i], or -A[N + c - i] past c."""
    g = torch.Generator().manual_seed(7)
    n, chunks, o = TOY.polynomial_size, 2, 3
    glwes = torch.randint(-(2**63), 2**63 - 1, (2, chunks, 2, n), generator=g)
    w = torch.randint(-128, 128, (chunks * n - 5, o), generator=g)
    got = rm.extracted_products(TOY, glwes, w)
    for b in range(2):
        for oo in range(o):
            want = [0] * (n + 1)
            for c in range(w.shape[0]):
                ch, j = divmod(c, n)
                a, body = glwes[b, ch, 0].tolist(), glwes[b, ch, 1, j].item()
                ext = [a[j - i] if i <= j else -a[n + j - i] for i in range(n)] + [body]
                want = [_wrap(x + w[c, oo].item() * y) for x, y in zip(want, ext)]
            assert got[b, oo].tolist() == want


def test_packing_keyswitch_keeps_each_phase():
    """Output t's coefficient t holds input t's phase, up to the digits'
    rounding (24 bits kept: up to 2^39 on each of 16 key bits) and the
    keyswitch's noise, on 20 LWEs over two output polynomials."""
    keys = rm.keygen(TOY, 99, "cpu")
    s_in, n = keys.input_key.reshape(-1), TOY.polynomial_size
    g = torch.Generator().manual_seed(3)
    msgs = torch.randint(0, 1 << 10, (2, 20), generator=g)
    mask = torch.randint(-(2**63), 2**63 - 1, (2, 20, n), generator=g)
    lwes = torch.cat([mask, (msgs * TOY.delta + (mask * s_in).sum(-1))[..., None]], dim=-1)
    packed = rm.packing_keyswitch(TOY, keys.pksk, lwes)
    assert packed.shape == (2, 2, 2, n)
    phase = (packed[:, :, 1] - rt.glwe_mask_times_key(packed[:, :, :1], keys.post_key)).reshape(2, -1)[:, :20]
    assert rt.centered(phase - msgs * TOY.delta).max().item() < 2**43 + 2**21
    assert packed[:, 1, :, 4:].abs().sum().item() != 0  # unused coefficients hold keyswitch noise, as in the program


def test_limb_bits_keep_float64_sums_exact():
    assert rm.limb_bits(128, 2048) == 32  # 2 limbs: 2^32 x 2^7 x 2^11 = 2^50
    assert rm.limb_bits(1 << 13, 4096) == 22  # 3 limbs: 2^22 x 2^13 x 2^12 = 2^47


def test_params_built_from_the_file_are_the_programs_named_set():
    """`system.matmul_params` turns the file's numbers into the program's
    PARAMS_8B_2048 (and the toy file into TOY_MATMUL): the run measures the
    set the program names. This is no check against the set's source, whose
    numbers the file's `assumed` says were copied from the program."""
    import dataclasses

    from tfhe_tpu_torch import params as tp

    cfg = json.loads((ROOT / "benchmark" / "configs" / "ml_glwe_8b.json").read_text())
    assert system.matmul_params(cfg) == dataclasses.replace(tp.PARAMS_8B_2048, name=cfg["parameter_set"])
    toy = json.loads((DATA / "toy_matmul.json").read_text())
    assert system.matmul_params(toy) == tp.TOY_MATMUL


def test_reference_and_program_agree_at_toy_size():
    """From one seed: the same input and post keys; the program's product of
    the benchmark's encryptions decrypts (with its own key and the
    reference's) to the clear product, as the reference's does, and the two
    outputs' phases lie within the toy gap."""
    from tfhe_tpu_torch.models import glwe_matmul as gm

    cfg = json.loads((DATA / "toy_matmul.json").read_text())
    p, prog = rm.Params.from_config(cfg), system.matmul_params(cfg)
    seed = 2**31 + 77
    pkey = gm.create_private_key(prog, seed=seed, device="cpu")
    keys = rm.keygen(p, seed, "cpu")
    assert torch.equal(keys.input_key, pkey.glwe_key.key) and torch.equal(keys.post_key, pkey.post_key.key)
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 16, (3, 300), generator=g)
    w = torch.randint(-8, 8, (300, 260), generator=g)
    glwes = rm.encrypt_rows(p, rm.input_key(p, seed, "cpu"), x, g)
    enc = gm.EncryptedMatrix(glwes=glwes, params=prog, n_valid=300, shape=(3, 300))
    out = gm.matrix_multiplication(enc, gm.prepare_clear_weights(prog, w, device="cpu"), pkey)
    ref = rm.matmul(p, keys, glwes, w)
    clear = x @ w
    assert torch.equal(gm.decrypt_matrix(out, pkey), clear)
    space, log_delta = 1 << p.bits_reserved_for_computation, 64 - p.bits_reserved_for_computation
    for stored in (out.data, ref):
        ph = rm.output_phase(p, keys.post_key, stored, 260)
        got = rt.srl(ph + (1 << (log_delta - 1)), log_delta) & (space - 1)
        assert torch.equal(got - torch.where(got >= space // 2, space, 0), clear)
        assert rt.centered(ph - clear * p.delta).max().item() < 2**MATMUL_LIMITS["err_bits"]
    gap = rt.centered(rm.output_phase(p, keys.post_key, out.data, 260) - rm.output_phase(p, keys.post_key, ref, 260))
    assert gap.max().item() < 2**MATMUL_LIMITS["gap_bits"]


def test_toy_cell_is_correct():
    cell = toy_cell("toy_matmul", "toy_matmul_mix", MATMUL_LIMITS)
    res = harness.execute(ROOT, cell.name, 2**31 + 5, 1.5, False, "cpu", time.perf_counter(), cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["wrong_outputs"]["value"] == 0
    assert res["metrics"]["gmac_per_s"]["value"] > 0 and res["attempted"] >= len(cell.traffic["layers"])


def test_roofline_reader_sums_the_layers():
    """The window's bound is each layer's frozen bound times its matmuls."""
    import types

    from benchmark import harness as h

    cell = toy_cell("toy_matmul", "toy_matmul_mix", MATMUL_LIMITS)
    c, t = cell.config, cell.traffic
    run = types.SimpleNamespace(cell=cell, facts={"layer_calls": {"square": 3, "narrow": 2}},
                                trace=types.SimpleNamespace(window_s=2.0))
    want = sum(n * roofline.matmul_bound_s(t["rows"], spec["inner"], spec["out"], 1, 3, c["polynomial_size"], 2)
               for n, spec in zip((3, 2), t["layers"]))
    assert h.reader("matmul_roofline.matmul").read(run) == pytest.approx(100.0 * want / 2.0)


def test_matmul_roofline_counts_at_a_toy_shape():
    """rows 2, inner 8, out 4, k 1, P 3, N 8, level 2; an NTT of one row at
    one prime is 4 x 3 x 10 + 8 x 5 = 160 operations. Inputs' forward 4 rows
    1,920; products 8 x 2 x 3 x 8 x 5 = 1,920; masks' inverse 8 rows 3,840
    and Garner 8 x 8 x 40 = 2,560; body 8 x 3 x 8 x 5 + 8 x 40 = 1,280;
    keyswitch digits 8 x 8 x 2 x 6 = 768, their forward 32 rows 15,360, MAC
    32 x 2 x 3 x 8 x 7 = 10,752, inverse 4 rows 1,920 and Garner 4 x 8 x 40 =
    1,280; switch 4 x 8 x 2 = 64. Bytes: inputs 256, weights 4 x 3 x 2 x 8 x
    4 = 768, key 8 x 2 x 2 x 3 x 2 x 8 x 4 = 6,144, outputs 128."""
    shape = (2, 8, 4, 1, 3, 8, 2)
    assert roofline.matmul_ops(*shape) == 41_664
    assert roofline.matmul_bytes(*shape) == 7_296
    assert roofline.matmul_bound_s(*shape) == 7_296 / roofline.HBM_BYTES_PER_S  # bytes bound it at this size
    for inner, out in ((2048, 512), (2048, 8192), (8192, 2048)):  # the cell's layers: operations bound them
        full = (8, inner, out, 1, 3, 2048, 2)
        assert roofline.matmul_bound_s(*full) == roofline.matmul_ops(*full) / roofline.ALU_OPS_PER_S


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_program_at_cell_size(card, seed):
    """The program's readings at the cell's size: a window long enough to
    run every input of every layer."""
    cell = harness.load_cell(ROOT, "ml_matmul_8b")
    t0 = time.perf_counter()
    res = harness.execute(ROOT, cell.name, seed, 10.0, False, card, t0, cell)
    print(json.dumps({"workload": cell.name, "seed": seed, "checks": res["checks"], "attempted": res["attempted"],
                      "metrics": res["metrics"], "peak": res["device"]["memory_peak_bytes"],
                      "seconds": time.perf_counter() - t0}))
    assert res["attempted"] >= cell.traffic["input_matrices"] * len(cell.traffic["layers"])
    assert res["correct"], res["checks"]

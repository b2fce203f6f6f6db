#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tfhe_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from tfhe_tpu_torch/csrc with nvcc and
holds each kernel against its plain PyTorch version on the card at the
shapes the main paths give it (bit-exact; the forward NTT mod p). Then it
drives, through the entry points a user calls, at full width:

1. the classic shortint path at PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
   (K1/K2 in keygen, K3 in every PBS): keygen, encrypt 512 values,
   apply_lut (identity and v -> 3v mod 4), one mul, decrypt and check;
2. the multi-bit path at PARAM_MULTI_BIT_GROUP_3_... (K4 in every PBS):
   the same steps, then a GROUP_4 keygen with 64 ciphertexts through the
   identity LUT;
3. an encrypted ERC20 transfer at euint64 over the GROUP_3 key, batch 32
   (le, select against a trivial zero, add_sub), checked against numpy.

The launch counts are set to 0 just before each path and read just
after it; the kernel-vs-plain comparisons run outside those windows. It
prints the card, build time, per-kernel times beside their bounds,
keygen seconds, PBS/s, transfers/s, K4's time at 64, 128 and 512
ciphertexts (`ms_by_batch`), a `{"kernels": [...]}` line, and last
a `{"ok": true, "device": {...}}` line. Any failure raises and exits
non-zero; with no CUDA device it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 1234
BATCH = 512
ERC20_BATCH = 32
ERC20_BITS = 64
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# non-tensor-core 32-bit rate, used here as the peak of the kernels' u32
# integer instructions.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# 32-bit integer instructions counted per unit of work (from the kernels'
# source): a butterfly is a Shoup multiply (mul.hi, two mul.lo, sub,
# compare-select) plus an add-mod and a sub-mod (two each).
OPS_BUTTERFLY = 10
OPS_MULMOD = 5
OPS_ADDMOD = 2
OPS_GARNER = 40  # per coefficient: three u64 remainders and the Horner


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / ALU_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ntt_ops(rows: int, n_pr: int, n: int) -> float:
    return rows * n_pr * ((n // 2) * int(math.log2(n)) * OPS_BUTTERFLY + n * OPS_MULMOD)


def cmux_ops(batch: int, steps: int, n_pr: int, n: int) -> float:
    per_prime = (
        2 * ntt_ops(2, 1, n)  # forward + inverse of the 2 rows
        + 2 * n * 6  # decomposition
        + n * 5 * OPS_MULMOD  # EP (4 mulmods + add) and the (X^a - 1) multiply
    )
    return batch * steps * (n_pr * per_prime + 2 * n * OPS_GARNER)


def group_step_ops(batch: int, groups: int, g: int, n_pr: int, n: int) -> float:
    v = 1 << g
    pointwise = 2 * (2 * v * OPS_MULMOD + v * OPS_ADDMOD + (v - 1) * (OPS_MULMOD + OPS_ADDMOD))
    per_prime = 2 * ntt_ops(2, 1, n) + 2 * n * 6 + n * pointwise
    return batch * groups * (n_pr * per_prime + 2 * n * OPS_GARNER)


def rotation_bytes(batch: int, steps: int, key_bytes: int, rows_per_step: int, n_pr: int, n: int) -> int:
    """Accumulators in and out, the mask exponents, the key read once, and
    the monomial-table rows each ciphertext gathers at each step."""
    return 2 * batch * 2 * n * 8 + steps * rows_per_step * batch * 4 + key_bytes + (
        steps * rows_per_step * batch * n_pr * 2 * n * 4
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.core import bootstrap as bt
    from tfhe_tpu_torch.core import multibit as mb
    from tfhe_tpu_torch.core.lwe import keyswitch
    from tfhe_tpu_torch.models import integer as ri
    from tfhe_tpu_torch.models import shortint as si
    from tfhe_tpu_torch.ops import blind_rotate_cuda as brc
    from tfhe_tpu_torch.ops import multibit_cuda as mbc
    from tfhe_tpu_torch.ops import ntt_cuda
    from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
    from tfhe_tpu_torch.rng import FheRng
    from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate

    PARAMS = tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    MB3 = tp.PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    MB4 = tp.PARAM_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # -- build ----------------------------------------------------------------
    build_s = _build.build_all()
    ptxas = []
    for name in _build.SOURCES:
        for line in _build.log_path(name).read_text().splitlines() if _build.log_path(name).exists() else []:
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                ptxas.append(line.strip())
    print(f"build_s: {build_s:.3f} (" + "; ".join(ptxas) + ")", flush=True)

    wrappers = {"K1": ntt_cuda.forward, "K2": ntt_cuda.inverse, "K3": brc.cmux_steps, "K4": mbc.group_steps}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: w.launches for k, w in wrappers.items()}

    n = PARAMS.polynomial_size
    eng = get_folded_engine(n, dev)
    n_pr = eng.n_primes
    primes = torch.tensor(eng.primes, device=dev).view(1, n_pr, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kern = {}
    paths = {}

    def rand_i32(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def rand_u64(shape):
        hi = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
        lo = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
        return (hi << 32) | lo

    def rand_key_rows(lead):
        res = torch.remainder(rand_u64(lead + (n_pr, n)) & 0x3FFFFFFF, primes.view(n_pr, 1))
        return eng.make_shoup(res.to(torch.int32))

    def mod_err(a, b):
        return int(((a.to(torch.int64) % primes) - (b.to(torch.int64) % primes)).abs().max())

    def exact_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    # -- kernels vs plain ------------------------------------------------------
    # K1 on 512 random rows, nb=3 (|x| <= 2^23) and nb=4 (|x| < 2^31)
    x3 = rand_i32((512, n), -(2**23), 2**23 + 1)
    x4 = rand_i32((512, n), -(2**31) + 1, 2**31)
    e3 = mod_err(eng.forward_small(x3), eng.forward_small_plain(x3))
    f4 = ntt_cuda.forward(eng, x4, small=True)
    e4 = mod_err(f4, eng.forward_i32_plain(x4))
    check(e3 == 0 and e4 == 0, f"K1 vs plain (nb=3 err {e3}, nb=4 err {e4})")
    k2_512 = exact_err(ntt_cuda.inverse(eng, f4), eng.inverse_plain(f4))
    check(k2_512 == 0, f"K2 vs plain on the K1 output (err {k2_512})")
    print(f"check K1 (512, {n}) nb=3 err {e3}, nb=4 err {e4}; K2 (512, {n_pr}, {n}) err {k2_512}", flush=True)

    # K1 at the main path's largest call: a monomial table, 2N small rows
    polys = rand_i32((2 * n, n), -1, 2)
    k1_err = mod_err(eng.forward_small(polys), eng.forward_small_plain(polys))
    check(k1_err == 0, f"K1 vs plain at (2N, N) (err {k1_err})")
    k1_ms = cuda_ms(lambda: eng.forward_small(polys), 10)
    k1_plain_ms = cuda_ms(lambda: eng.forward_small_plain(polys), 2)
    b, o = bound_ms(2 * n * n * 4 + 2 * n * n_pr * n * 4, ntt_ops(2 * n, n_pr, n))
    kern["K1"] = dict(
        name="ntt_forward", route="cuda", source="tfhe_tpu_torch/csrc/ntt.cu",
        replaces="tfhe_tpu/ops/pallas_ntt.py:494", max_abs_err=k1_err, ms=k1_ms,
        plain_ms=k1_plain_ms, bound_ms=b, bound_by=o, library_ms=None, path="classic",
        shape=f"({2 * n}, {n}) int32 -> ({2 * n}, {n_pr}, {n})",
    )
    # K1 on u64 rows (forward_u64: GGSW rows of the bootstrap key)
    u = rand_u64((4 * PARAMS.lwe_dimension, n))
    k1u_err = mod_err(eng.forward_u64(u), eng.forward_u64_plain(u))
    check(k1u_err == 0, f"K1 (u64 input) vs plain (err {k1u_err})")
    # K2 at the classic path's call: GLWE encryption of the bootstrap key
    rows2 = 2 * PARAMS.lwe_dimension
    f2 = eng.forward_u64(rand_u64((rows2, n)))
    k2_err = exact_err(ntt_cuda.inverse(eng, f2), eng.inverse_plain(f2))
    check(k2_err == 0, f"K2 vs plain at ({rows2}, P, N) (err {k2_err})")
    k2_ms = cuda_ms(lambda: ntt_cuda.inverse(eng, f2), 10)
    k2_plain_ms = cuda_ms(lambda: eng.inverse_plain(f2), 2)
    b, o = bound_ms(2 * rows2 * n_pr * n * 4, ntt_ops(rows2, n_pr, n) + rows2 * n_pr * n * OPS_MULMOD)
    kern["K2"] = dict(
        name="ntt_inverse", route="cuda", source="tfhe_tpu_torch/csrc/ntt.cu",
        replaces="tfhe_tpu/ops/pallas_ntt.py:518", max_abs_err=k2_err, ms=k2_ms,
        plain_ms=k2_plain_ms, bound_ms=b, bound_by=o, library_ms=None, path="classic",
        shape=f"({rows2}, {n_pr}, {n})",
    )
    print(f"check K1 ({2 * n}, {n}) err {k1_err}, u64 ({4 * PARAMS.lwe_dimension}, {n}) err {k1u_err}; "
          f"K2 ({rows2}, {n_pr}, {n}) err {k2_err}", flush=True)

    # K3: one launch of 4 steps over 64 ciphertexts, random accumulators and key rows
    rot_table = brc.monomial_ntt_table(eng)
    base_log = PARAMS.pbs.base_log
    acc = rand_u64((64, 2, n))
    exps = rand_i32((4, 64), 0, 2 * n)
    bsk = rand_key_rows((4, 2, 2))
    k3s_err = exact_err(
        brc.cmux_steps(acc, exps, bsk, rot_table, eng, base_log, 11),
        brc.cmux_steps_plain(acc, exps, bsk, rot_table, eng, base_log, 11),
    )
    check(k3s_err == 0, f"K3 vs plain, 4 steps x 64 ciphertexts (err {k3s_err})")
    # K4: one launch of 4 groups for each group size, at ragged batches of 1, 3
    # and 64 ciphertexts (the grid holds one block per ciphertext and prime)
    x_table = mb.monomial_x_table(eng)
    k4s_err = {}
    for g in mbc.GROUP_SIZES:
        bsk = rand_key_rows((4, 1 << g, 2, 2))
        for nb in (1, 3, 64):
            a = rand_i32((4 * g, nb), 0, 2 * n)
            k4s_err[f"g{g}/{nb}ct"] = exact_err(
                mbc.group_steps(acc[:nb], a, bsk, x_table, eng, base_log, 13, g),
                mbc.group_steps_plain(acc[:nb], a, bsk, x_table, eng, base_log, 13, g),
            )
    check(all(e == 0 for e in k4s_err.values()), f"K4 vs plain, 4 groups x 1/3/64 ciphertexts (err {k4s_err})")
    del bsk, x_table
    print(f"check K3 (64 ct, 4 steps) err {k3s_err}; K4 (4 groups) err by g and batch {k4s_err}", flush=True)

    # -- path 1: the classic shortint path at full width ----------------------
    reset_counts()
    t0 = time.perf_counter()
    ck, sk = si.keygen(PARAMS, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    rng = FheRng(SEED + 1, "cuda")
    vals = torch.arange(BATCH, device=dev) % PARAMS.message_modulus
    vals_b = (vals * 3 + 1) % PARAMS.message_modulus
    space = PARAMS.message_modulus * PARAMS.carry_modulus
    c = si.encrypt(ck, vals, rng)
    ident = si.apply_lut(sk, c, si.generate_lut(PARAMS, lambda v: v, "cuda"), 3)
    tri = si.apply_function(sk, c, lambda v: (3 * v) % 4)
    prod = si.mul(sk, c, si.encrypt(ck, vals_b, rng))
    paths["classic"] = read_counts()
    check(bool((si.decrypt(ck, ident) == vals).all()), "classic: identity LUT decrypts to the inputs")
    check(bool((si.decrypt(ck, tri) == (3 * vals) % 4).all()), "classic: v -> 3v mod 4 decrypts")
    check(bool((si.decrypt(ck, prod) == (vals * vals_b) % space).all()), "classic: mul decrypts")
    lut3 = si.generate_lut(PARAMS, lambda v: (3 * v) % 4, "cuda")
    out_k = bt.keyswitch_pbs(c.ct[:8], lut3, sk.bsk, sk.ksk, eng)
    out_p = bt.keyswitch_pbs(c.ct[:8], lut3, sk.bsk, sk.ksk, eng, cmux=brc.cmux_steps_plain)
    pbs_err = exact_err(out_k, out_p)
    check(pbs_err == 0, f"classic: kernel-path PBS equals plain-path PBS on 8 ciphertexts (err {pbs_err})")
    check(all(paths["classic"][k] > 0 for k in ("K1", "K2", "K3")),
          f"K1-K3 launched on the classic path {paths['classic']}")
    print(f"classic path: keygen_s {keygen_s:.3f}; {BATCH} ct identity/3v/mul decrypt ok; "
          f"8-ct PBS kernel == plain (err {pbs_err}); launches {paths['classic']}", flush=True)

    pbs_ms = cuda_ms(lambda: si.apply_lut(sk, c, lut3, 3), 3)
    print(f"pbs: batch {BATCH}, {pbs_ms:.3f} ms per apply_lut, "
          f"{pbs_ms / BATCH:.6f} ms per PBS, {BATCH / pbs_ms * 1e3:.1f} PBS/s", flush=True)

    # K3 at the classic path's shape: all n steps of the 512-ciphertext rotation
    small = keyswitch(c.ct, sk.ksk)
    ms_ = mod_switch(small, int(math.log2(2 * n)))
    acc0 = negacyclic_monomial_rotate(lut3, (2 * n - ms_[..., -1])[..., None]).contiguous()
    e_all = ms_[..., :-1].t().to(torch.int32).contiguous()
    args = (acc0, e_all, sk.bsk.bsk_ntt, sk.bsk.rot_table, eng, base_log, sk.bsk.shift)
    k3_ms = cuda_ms(lambda: brc.cmux_steps(*args), 3)
    plain_out = None

    def k3_plain():
        nonlocal plain_out
        plain_out = brc.cmux_steps_plain(*args)

    k3_plain_ms = host_ms(k3_plain)
    k3_err = exact_err(brc.cmux_steps(*args), plain_out)
    check(k3_err == 0, f"K3 vs plain at the classic path's shape (err {k3_err})")
    steps = PARAMS.lwe_dimension
    b, o = bound_ms(
        rotation_bytes(BATCH, steps, sk.bsk.bsk_ntt.numel() * 4, 1, n_pr, n),
        cmux_ops(BATCH, steps, n_pr, n),
    )
    kern["K3"] = dict(
        name="cmux_steps", route="cuda", source="tfhe_tpu_torch/csrc/blind_rotate.cu",
        replaces="tfhe_tpu/ops/pallas_blind_rotate.py:279", max_abs_err=max(k3_err, k3s_err, pbs_err),
        ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=b, bound_by=o, library_ms=None, path="classic",
        shape=f"{BATCH} ct x {steps} steps",
    )
    del ck, sk, c, ident, tri, prod, small, acc0, args, plain_out, rot_table

    # -- path 2: the multi-bit path, GROUP_3 at full width --------------------
    g3 = si.multibit_group_of(MB3)
    reset_counts()
    t0 = time.perf_counter()
    ck, sk = si.keygen(MB3, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    mb_keygen_s = time.perf_counter() - t0
    rng = FheRng(SEED + 2, "cuda")
    c = si.encrypt(ck, vals, rng)
    ident = si.apply_lut(sk, c, si.generate_lut(MB3, lambda v: v, "cuda"), 3)
    tri = si.apply_function(sk, c, lambda v: (3 * v) % 4)
    prod = si.mul(sk, c, si.encrypt(ck, vals_b, rng))
    paths["multibit"] = read_counts()
    check(isinstance(sk.bsk, mb.MultiBitBootstrapKey) and sk.bsk.group_size == g3, "GROUP_3 keygen gives a g=3 key")
    check(bool((si.decrypt(ck, ident) == vals).all()), "GROUP_3: identity LUT decrypts to the inputs")
    check(bool((si.decrypt(ck, tri) == (3 * vals) % 4).all()), "GROUP_3: v -> 3v mod 4 decrypts")
    check(bool((si.decrypt(ck, prod) == (vals * vals_b) % space).all()), "GROUP_3: mul decrypts")
    check(paths["multibit"]["K4"] > 0 and paths["multibit"]["K3"] == 0,
          f"K4 (and not K3) launched on the multi-bit path {paths['multibit']}")
    lut3 = si.generate_lut(MB3, lambda v: (3 * v) % 4, "cuda")
    out_k = mb.multibit_keyswitch_pbs(c.ct[:8], lut3, sk.bsk, sk.ksk, eng)
    out_p = mb.multibit_keyswitch_pbs(c.ct[:8], lut3, sk.bsk, sk.ksk, eng, steps=mbc.group_steps_plain)
    mb_pbs_err = exact_err(out_k, out_p)
    check(mb_pbs_err == 0, f"GROUP_3: kernel-path PBS equals plain-path PBS on 8 ciphertexts (err {mb_pbs_err})")
    print(f"multibit path (GROUP_3, n={MB3.lwe_dimension}, g={g3}): keygen_s {mb_keygen_s:.3f}; "
          f"{BATCH} ct identity/3v/mul decrypt ok; 8-ct PBS kernel == plain (err {mb_pbs_err}); "
          f"launches {paths['multibit']}", flush=True)

    mb_pbs_ms = cuda_ms(lambda: si.apply_lut(sk, c, lut3, 3), 3)
    print(f"pbs_multibit: batch {BATCH}, {mb_pbs_ms:.3f} ms per apply_lut, "
          f"{mb_pbs_ms / BATCH:.6f} ms per PBS, {BATCH / mb_pbs_ms * 1e3:.1f} PBS/s", flush=True)

    # K4 at the multi-bit path's shape: all n/g groups of the 512-ciphertext rotation
    small = keyswitch(c.ct, sk.ksk)
    ms_ = mod_switch(small, int(math.log2(2 * n)))
    acc0 = negacyclic_monomial_rotate(lut3, (2 * n - ms_[..., -1])[..., None]).contiguous()
    a_all = ms_[..., :-1].t().to(torch.int32).contiguous()
    k4_args = (sk.bsk.bsk_ntt, sk.bsk.rot_table, eng, base_log, sk.bsk.shift, g3)
    k4_ms = cuda_ms(lambda: mbc.group_steps(acc0, a_all, *k4_args), 3)
    k4_out = mbc.group_steps(acc0, a_all, *k4_args)
    plain_out = None

    def k4_plain():
        nonlocal plain_out
        plain_out = mbc.group_steps_plain(acc0[:64], a_all[:, :64], *k4_args)

    k4_plain_ms = host_ms(k4_plain)
    k4_err = exact_err(k4_out[:64], plain_out)
    check(k4_err == 0, f"K4 vs plain at the multi-bit path's shape, first 64 ct (err {k4_err})")
    groups = sk.bsk.n_groups
    key_bytes = sk.bsk.bsk_ntt.numel() * 4

    def k4_bound(nb):
        return bound_ms(rotation_bytes(nb, groups, key_bytes, g3, n_pr, n), group_step_ops(nb, groups, g3, n_pr, n))

    # the ERC20 carry chain launches K4 on 64-128 rows: time those batches too
    ms_by_batch = {}
    for nb in (64, 128):
        acc_b, a_b = acc0[:nb].contiguous(), a_all[:, :nb].contiguous()
        t_b = cuda_ms(lambda: mbc.group_steps(acc_b, a_b, *k4_args), 3)
        ms_by_batch[str(nb)] = dict(zip(("ms", "bound_ms", "bound_by"), (t_b, *k4_bound(nb))))
    b, o = k4_bound(BATCH)
    ms_by_batch[str(BATCH)] = dict(ms=k4_ms, bound_ms=b, bound_by=o)
    kern["K4"] = dict(
        name="group_steps", route="cuda", source="tfhe_tpu_torch/csrc/multibit.cu",
        replaces="tfhe_tpu/ops/pallas_multibit.py:184",
        max_abs_err=max(k4_err, mb_pbs_err, *k4s_err.values()),
        ms=k4_ms, plain_ms=k4_plain_ms, plain_shape=f"64 ct x {groups} groups", bound_ms=b, bound_by=o,
        library_ms=None, path="multibit", shape=f"{BATCH} ct x {groups} groups (g={g3})",
        ms_by_batch=ms_by_batch,
    )
    print(f"K4 plain on 64 ct x {groups} groups: {k4_plain_ms:.1f} ms (kernel output equal, err {k4_err}); "
          "K4 by batch: " + ", ".join(
              f"{nb} ct {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} by {v['bound_by']})" for nb, v in ms_by_batch.items()
          ), flush=True)
    del small, acc0, a_all, k4_out, plain_out, ident, tri, prod

    # GROUP_4: keygen, 64 ciphertexts through the identity LUT
    t0 = time.perf_counter()
    ck4, sk4 = si.keygen(MB4, seed=SEED + 3, device="cuda")
    torch.cuda.synchronize()
    g4_keygen_s = time.perf_counter() - t0
    check(sk4.bsk.group_size == 4, "GROUP_4 keygen gives a g=4 key")
    v64 = vals[:64]
    c4 = si.encrypt(ck4, v64, FheRng(SEED + 4, "cuda"))
    id4 = si.apply_lut(sk4, c4, si.generate_lut(MB4, lambda v: v, "cuda"), 3)
    check(bool((si.decrypt(ck4, id4) == v64).all()), "GROUP_4: identity LUT decrypts to the inputs")
    print(f"GROUP_4 (n={MB4.lwe_dimension}, g=4): keygen_s {g4_keygen_s:.3f}; 64 ct identity decrypt ok", flush=True)
    del ck4, sk4, c4, id4

    # -- path 3: encrypted ERC20 transfer, euint64 over the GROUP_3 key --------
    host = np.random.default_rng(3)
    bal = host.integers(0, 1 << 32, ERC20_BATCH, dtype=np.uint64)
    amt = host.integers(0, 1 << 33, ERC20_BATCH, dtype=np.uint64)  # some overdraw
    e_bal = ri.encrypt_radix(ck, bal, ERC20_BITS, FheRng(5, "cuda"))
    e_amt = ri.encrypt_radix(ck, amt, ERC20_BITS, FheRng(6, "cuda"))

    def transfer(balance, amount):
        can_pay = ri.le(sk, amount, balance)
        zero = ri.trivial_radix(MB3, np.zeros(ERC20_BATCH, dtype=np.uint64), ERC20_BITS, "cuda")
        moved = ri.select(sk, can_pay, amount, zero)  # trivial-zero path: one PBS per block
        new_to, new_from = ri.add_sub(sk, balance, moved)  # one stacked carry chain
        return new_from, new_to

    reset_counts()
    ri._pbs.rows = 0
    new_from, new_to = transfer(e_bal, e_amt)
    paths["erc20"] = read_counts()
    pbs_per_transfer = ri._pbs.rows / ERC20_BATCH
    moved = np.where(amt <= bal, amt, 0)
    from_np = ri.decrypt_radix(ck, new_from).cpu().numpy().view(np.uint64)
    to_np = ri.decrypt_radix(ck, new_to).cpu().numpy().view(np.uint64)
    check(bool((from_np == bal - moved).all()), "ERC20: sender balances decrypt to bal - moved")
    check(bool((to_np == bal + moved).all()), "ERC20: receiver balances decrypt to bal + moved")
    check(paths["erc20"]["K4"] > 0, f"K4 launched on the ERC20 path {paths['erc20']}")
    erc20_ms = host_ms(lambda: transfer(e_bal, e_amt))
    print(f"erc20: euint{ERC20_BITS} over GROUP_3, batch {ERC20_BATCH}, {erc20_ms:.3f} ms per batch, "
          f"{ERC20_BATCH / erc20_ms * 1e3:.3f} transfers/s, {pbs_per_transfer:.1f} PBS per transfer (counted); "
          f"{int(moved.astype(bool).sum())} of {ERC20_BATCH} paid; launches {paths['erc20']}", flush=True)

    # -- summary ----------------------------------------------------------------
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "equal", "ms",
             "plain_ms", "plain_shape", "bound_ms", "bound_by", "library_ms", "path", "launches_by_path", "shape",
             "ms_by_batch")
    for key, k in kern.items():
        k["launches"] = paths[k["path"]][key]
        k["launches_by_path"] = {p: counts[key] for p, counts in paths.items()}
        k["equal"] = k["max_abs_err"] == 0
        check(k["launches"] > 0 and k["equal"], f"{key} launched on its path and equal to its plain version")
        plain = f"plain {k['plain_ms']:.4f} ms" + (f" on {k['plain_shape']}" if "plain_shape" in k else "")
        print(f"{key} {k['name']} {k['shape']}: {k['ms']:.4f} ms ({plain}, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}), launches {k['launches_by_path']}", flush=True)
    print(json.dumps({"kernels": [{f: k[f] for f in order if f in k} for k in kern.values()]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

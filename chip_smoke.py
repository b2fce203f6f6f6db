#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tfhe_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from tfhe_tpu_torch/csrc with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes the main path gives it (bit-exact; the forward NTT mod p), then
drives the classic shortint path at the full width of
PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128: keygen, encrypt 512
values, apply_lut (identity and v -> 3v mod 4), one mul, decrypt and
check every value, and a kernel-path vs plain-path PBS on 8 ciphertexts.
It prints the card, build time, per-kernel times beside their bounds,
keygen seconds and PBS/s, a `{"kernels": [...]}` line, and last a
`{"ok": true, "device": {...}}` line. Any failure raises and exits
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
    return batch * steps * (n_pr * per_prime + 2 * n * 40)  # + Garner per coefficient


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch.core import bootstrap as bt
    from tfhe_tpu_torch.models import shortint as si
    from tfhe_tpu_torch.ops import blind_rotate_cuda as brc
    from tfhe_tpu_torch.ops import ntt_cuda
    from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
    from tfhe_tpu_torch.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as PARAMS
    from tfhe_tpu_torch.rng import FheRng

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # -- phase 2: build ------------------------------------------------------
    build_s = _build.build_all()
    ptxas = []
    for name in _build.SOURCES:
        for line in _build.log_path(name).read_text().splitlines() if _build.log_path(name).exists() else []:
            if "registers" in line or "Compiling entry" in line:
                ptxas.append(line.strip())
    print(f"build_s: {build_s:.3f} (" + "; ".join(ptxas) + ")", flush=True)

    n = PARAMS.polynomial_size
    eng = get_folded_engine(n, dev)
    n_pr = eng.n_primes
    primes = torch.tensor(eng.primes, device=dev).view(1, n_pr, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kern = {}

    def rand_i32(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def rand_u64(shape):
        hi = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
        lo = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
        return (hi << 32) | lo

    def mod_err(a, b):
        return int(((a.to(torch.int64) % primes) - (b.to(torch.int64) % primes)).abs().max())

    def exact_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    # -- phase 3: kernels vs plain -------------------------------------------
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

    # K1 at the main path's largest call: the monomial table, 2N small rows
    polys = rand_i32((2 * n, n), -1, 2)
    k1_err = mod_err(eng.forward_small(polys), eng.forward_small_plain(polys))
    check(k1_err == 0, f"K1 vs plain at (2N, N) (err {k1_err})")
    k1_ms = cuda_ms(lambda: eng.forward_small(polys), 10)
    k1_plain_ms = cuda_ms(lambda: eng.forward_small_plain(polys), 2)
    b, o = bound_ms(2 * n * n * 4 + 2 * n * n_pr * n * 4, ntt_ops(2 * n, n_pr, n))
    kern["K1"] = dict(
        name="ntt_forward", route="cuda", source="tfhe_tpu_torch/csrc/ntt.cu",
        replaces="tfhe_tpu/ops/pallas_ntt.py:494", max_abs_err=k1_err, ms=k1_ms,
        plain_ms=k1_plain_ms, bound_ms=b, bound_by=o, library_ms=None,
        shape=f"({2 * n}, {n}) int32 -> ({2 * n}, {n_pr}, {n})",
    )
    # K1 on u64 rows (forward_u64: GGSW rows of the bootstrap key)
    u = rand_u64((4 * PARAMS.lwe_dimension, n))
    k1u_err = mod_err(eng.forward_u64(u), eng.forward_u64_plain(u))
    check(k1u_err == 0, f"K1 (u64 input) vs plain (err {k1u_err})")
    # K2 at the main path's call: GLWE encryption of the bootstrap key
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
        plain_ms=k2_plain_ms, bound_ms=b, bound_by=o, library_ms=None,
        shape=f"({rows2}, {n_pr}, {n})",
    )
    print(f"check K1 ({2 * n}, {n}) err {k1_err}, u64 ({4 * PARAMS.lwe_dimension}, {n}) err {k1u_err}; "
          f"K2 ({rows2}, {n_pr}, {n}) err {k2_err}", flush=True)

    # K3: one launch of 4 steps over 64 ciphertexts, random accumulators and key rows
    rot_table = brc.monomial_ntt_table(eng)
    base_log, shift = PARAMS.pbs.base_log, 11
    acc = rand_u64((64, 2, n))
    exps = rand_i32((4, 64), 0, 2 * n)
    res = torch.remainder(rand_u64((4, 2, 2, n_pr, n)) & 0x3FFFFFFF, primes.view(n_pr, 1))
    bsk = eng.make_shoup(res.to(torch.int32))
    k3s_err = exact_err(
        brc.cmux_steps(acc, exps, bsk, rot_table, eng, base_log, shift),
        brc.cmux_steps_plain(acc, exps, bsk, rot_table, eng, base_log, shift),
    )
    check(k3s_err == 0, f"K3 vs plain, 4 steps x 64 ciphertexts (err {k3s_err})")
    print(f"check K3 (64 ct, 4 steps) err {k3s_err}", flush=True)

    # -- phase 4: the main path at full width ---------------------------------
    for w in (ntt_cuda.forward, ntt_cuda.inverse, brc.cmux_steps):
        w.launches = 0
    t0 = time.perf_counter()
    ck, sk = si.keygen(PARAMS, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    rng = FheRng(SEED + 1, "cuda")
    vals = torch.arange(BATCH, device=dev) % PARAMS.message_modulus
    c = si.encrypt(ck, vals, rng)
    ident = si.apply_lut(sk, c, si.generate_lut(PARAMS, lambda v: v, "cuda"), 3)
    check(bool((si.decrypt(ck, ident) == vals).all()), "identity LUT decrypts to the inputs")
    tri = si.apply_function(sk, c, lambda v: (3 * v) % 4)
    check(bool((si.decrypt(ck, tri) == (3 * vals) % 4).all()), "v -> 3v mod 4 decrypts")
    vals_b = (vals * 3 + 1) % PARAMS.message_modulus
    prod = si.mul(sk, c, si.encrypt(ck, vals_b, rng))
    space = PARAMS.message_modulus * PARAMS.carry_modulus
    check(bool((si.decrypt(ck, prod) == (vals * vals_b) % space).all()), "mul decrypts")
    lut3 = si.generate_lut(PARAMS, lambda v: (3 * v) % 4, "cuda")
    out_k = bt.keyswitch_pbs(c.ct[:8], lut3, sk.bsk, sk.ksk, eng)
    out_p = bt.keyswitch_pbs(c.ct[:8], lut3, sk.bsk, sk.ksk, eng, cmux=brc.cmux_steps_plain)
    pbs_err = exact_err(out_k, out_p)
    check(pbs_err == 0, f"kernel-path PBS equals plain-path PBS on 8 ciphertexts (err {pbs_err})")
    torch.cuda.synchronize()
    launches = {
        "K1": ntt_cuda.forward.launches,
        "K2": ntt_cuda.inverse.launches,
        "K3": brc.cmux_steps.launches,
    }
    check(all(v > 0 for v in launches.values()), f"every kernel launched on the main path {launches}")
    print(f"main path: keygen_s {keygen_s:.3f}; {BATCH} ct identity/3v/mul decrypt ok; "
          f"8-ct PBS kernel == plain (err {pbs_err}); launches {launches}", flush=True)

    # PBS throughput: apply_lut on the 512-ciphertext batch (warm)
    pbs_ms = cuda_ms(lambda: si.apply_lut(sk, c, lut3, 3), 3)
    print(f"pbs: batch {BATCH}, {pbs_ms:.3f} ms per apply_lut, "
          f"{pbs_ms / BATCH:.6f} ms per PBS, {BATCH / pbs_ms * 1e3:.1f} PBS/s", flush=True)

    # K3 at the main path's shape: all n steps of the 512-ciphertext rotation
    from tfhe_tpu_torch.core.lwe import keyswitch
    from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate

    small = keyswitch(c.ct, sk.ksk)
    ms_ = mod_switch(small, int(math.log2(2 * n)))
    acc0 = negacyclic_monomial_rotate(lut3, (2 * n - ms_[..., -1])[..., None]).contiguous()
    e_all = ms_[..., :-1].t().to(torch.int32).contiguous()
    args = (acc0, e_all, sk.bsk.bsk_ntt, sk.bsk.rot_table, eng, base_log, sk.bsk.shift)
    k3_ms = cuda_ms(lambda: brc.cmux_steps(*args), 3)
    t0 = time.perf_counter()
    plain_out = brc.cmux_steps_plain(*args)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    k3_err = exact_err(brc.cmux_steps(*args), plain_out)
    check(k3_err == 0, f"K3 vs plain at the main-path shape (err {k3_err})")
    steps = PARAMS.lwe_dimension
    distinct_rows = int(torch.unique(e_all).numel())
    k3_bytes = (
        2 * BATCH * 2 * n * 8 + steps * BATCH * 4
        + steps * 4 * n_pr * 2 * n * 4 + distinct_rows * n_pr * 2 * n * 4
    )
    b, o = bound_ms(k3_bytes, cmux_ops(BATCH, steps, n_pr, n))
    kern["K3"] = dict(
        name="cmux_steps", route="cuda", source="tfhe_tpu_torch/csrc/blind_rotate.cu",
        replaces="tfhe_tpu/ops/pallas_blind_rotate.py:279", max_abs_err=max(k3_err, k3s_err, pbs_err),
        ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=b, bound_by=o, library_ms=None,
        shape=f"{BATCH} ct x {steps} steps",
    )
    for key in kern:
        kern[key]["launches"] = launches[key]
        kern[key]["equal"] = kern[key]["max_abs_err"] == 0
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "equal", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    for key, k in kern.items():
        print(f"{key} {k['name']} {k['shape']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}), launches {k['launches']}", flush=True)
    print(json.dumps({"kernels": [{f: k[f] for f in order} for k in kern.values()]}), flush=True)
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

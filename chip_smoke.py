#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tfhe_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from tfhe_tpu_torch/csrc with nvcc and
holds each kernel against its plain PyTorch version on the card at the
shapes the main paths give it (bit-exact; the forward NTT mod p; K1 and
K2 also at the loop path's shapes, at ragged row counts of 1, 3 and 1537
with the extreme int32 and u64 inputs, at N = 1024 and 2048; K3 and K4
also at ragged batches of 1, 3 and 64 ciphertexts). Then it drives,
through the entry points a user calls, at full width:

1. the classic shortint path at PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
   (K1/K2 in keygen, K3 in every PBS): keygen, encrypt 512 values,
   apply_lut (identity and v -> 3v mod 4), one mul, decrypt and check;
2. the multi-bit path at PARAM_MULTI_BIT_GROUP_3_... (K4 in every PBS):
   the same steps, then a GROUP_4 keygen with 64 ciphertexts through the
   identity LUT;
3. an encrypted ERC20 transfer at euint64 over the GROUP_3 key, batch 32
   (le, select against a trivial zero, add_sub), checked against numpy;
4. the loop PBS at PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128 (k=2,
   N=1024; K1 and K2 once each per rotation step, 780 per apply_lut):
   keygen, encrypt 512 values in [0, 2), apply_lut (identity and
   v -> 1 - v), decrypt and check, then ms per apply_lut, per rotation
   step, K1/K2's share of a step and, where torch.profiler sees the card,
   the kernel time by name over one apply_lut (`pbs_loop:` lines);
5. boolean gates at BOOLEAN_PARAMS_128 (k=2, N=1024, PBS level 3, the loop
   path with 9 digit rows per ciphertext), batch 512 over every input
   combination: keygen, the six binary gates, not_ and mux decrypted
   against their truth tables, 680 K1 and 680 K2 launches per bootstrap
   (none for not_, three bootstraps for mux), K3/K4 never; AND gates/s,
   K1 at the step's (4608, 1024) against forward_i32_plain, and a
   torch.profiler window over one AND (`boolean:` lines);
6. the encrypted x clear matmul at PARAMS_8B_2048, enc(32 x 2048) x
   clear(2048 x 1024), 8-bit inputs and weights in [-7, 7]: keygen,
   encrypt and prepare seconds, ms per matmul on prepared weights and
   Gmac/s, the decrypted error against the clear product (err_max <= 256),
   2 K1 and 2 K2 launches per matmul, K1 at the packing keyswitch's
   (131072, 2048) and K2 at the masks' (32768, 3, 2048) against their
   plain versions (run in chunks of rows), and a profiler window over one
   matmul (`matmul:` lines);
7. GlweLinearLayerExecutor 2048 -> 1024 at batch 32 with keys on the card:
   EXECUTE within 256 accumulator LSBs of DISABLE (`linear:` line).

The launch counts are set to 0 just before each path and read just
after it; the kernel-vs-plain comparisons run outside those windows. It
prints the card, build time, per-kernel times beside their bounds,
keygen seconds, PBS/s, transfers/s, gates/s, ms per matmul and Gmac/s,
K3's and K4's times at 64, 128 and 512 ciphertexts (`ms_by_batch`), K1's
and K2's at the keygen, loop, boolean and matmul shapes (`ms_by_shape`),
ptxas's registers and spills, a `{"kernels": [...]}` line, and last a
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
ERC20_BATCH = 32
ERC20_BITS = 64
MM_R, MM_C, MM_O = 32, 2048, 1024  # enc(R x C) x clear(C x O), scripts/bench_matmul.py's shape
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


def self_device_us(ev) -> float:
    """An event's own device time in us (the attribute's name moved between
    torch releases)."""
    us = getattr(ev, "self_device_time_total", None)
    return getattr(ev, "self_cuda_time_total", 0) if us is None else us


def kernel_ms(fn, reps: int, symbol: str) -> dict:
    """A kernel's time: the mean device time per call of `fn` of the
    kernels whose name holds `symbol`, from torch.profiler (the wrapper's
    own tensor ops and launch cost excluded), beside the CUDA-event time of
    the whole call (`wrapper_ms`). Where the profiler does not record every
    launch, `ms` is the event time and `timed_by` says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wrapper = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if symbol in ev.key]
    dev = sum(self_device_us(ev) for ev in evs) / 1e3 / reps
    # a trace that lost some of the launches' events gives no kernel time
    if sum(e.count for e in evs) == reps and dev > 0:
        return dict(ms=dev, wrapper_ms=wrapper, timed_by="torch.profiler")
    return dict(ms=wrapper, wrapper_ms=wrapper, timed_by="cuda events")


def short(kernel: str) -> str:
    """A kernel's name without its namespaces and launch parameters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "at::detail::", "c10::"):
        kernel = kernel.replace(junk, "")
    return kernel[:110]


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_window(label: str, what: str, fn, steps: int | None, untraced_ms: float) -> dict:
    """One call of `fn` under torch.profiler: kernel launches (per rotation
    step where `steps` is given), the card's busy share of the window and
    of the untraced time, device time by kernel and by torch op, and K1's
    and K2's share, printed as `<label> profile:` lines."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_op = {}, {}
    for ev in prof.key_averages():
        us = self_device_us(ev)
        # kernels (device-side events) by name; the torch ops that launched
        # them report the same time, kept apart as the breakdown by op
        if us > 0:
            on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
            (by_name if on_device else by_op)[ev.key] = (us / 1e3, ev.count)
    if not by_name:
        print(f"{label} profile: torch.profiler recorded no device-side kernel events; the times above are "
              "CUDA events", flush=True)
        return {}
    dev_ms = sum(t for t, _ in by_name.values())
    launches = sum(cnt for _, cnt in by_name.values())
    per_step = f" ({launches / steps:.1f} per step)" if steps else ""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"{label} profile: {what}, {launches} kernel launches{per_step}, "
          f"device busy {dev_ms:.3f} ms: {100 * dev_ms / window_ms:.1f} % of the {window_ms:.3f} ms window "
          f"(profiler on), {100 * dev_ms / untraced_ms:.1f} % of the untraced {untraced_ms:.3f} ms; by kernel: "
          + "; ".join(f"{short(name)} {t:.3f} ms x{cnt}" for name, (t, cnt) in top), flush=True)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"{label} profile: device time by torch op: "
          + "; ".join(f"{name} {t:.3f} ms x{cnt}" for name, (t, cnt) in ops), flush=True)
    for key, sym in (("K1", "k1_forward"), ("K2", "k2_inverse")):
        t, cnt = [sum(v[i] for nm, v in by_name.items() if sym in nm) for i in (0, 1)]
        print(f"{label} profile: {key} on the path {t:.3f} ms over {cnt} launches "
              f"({100 * t / dev_ms:.1f} % of device time)", flush=True)
    return dict(launches=launches, dev_ms=dev_ms, window_ms=window_ms)


def chunked_vs_plain(plain, x, out, chunk: int, err_fn) -> tuple[int, float]:
    """A kernel's output `out` on `x` against `plain` run on chunks of rows:
    the largest error by `err_fn` and the plain version's total ms."""
    import torch

    err, ms = 0, 0.0
    for lo in range(0, x.shape[0], chunk):
        got = []
        ms += host_ms(lambda: got.append(plain(x[lo:lo + chunk])))
        err = max(err, err_fn(out[lo:lo + chunk], got[0]))
        del got
    torch.cuda.synchronize()
    return err, ms


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / ALU_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ntt_ops(rows: int, n_pr: int, n: int) -> float:
    return rows * n_pr * ((n // 2) * int(math.log2(n)) * OPS_BUTTERFLY + n * OPS_MULMOD)


def k1_bound(rows: int, n_pr: int, n: int, in_bytes: int) -> tuple[float, str]:
    """Rows of N values (in_bytes each) in, (rows, P, N) u32 residues out."""
    return bound_ms(rows * n * in_bytes + rows * n_pr * n * 4, ntt_ops(rows, n_pr, n))


def k2_bound(rows: int, n_pr: int, n: int) -> tuple[float, str]:
    """(rows, P, N) u32 residues in and out, the N^-1 scaling included."""
    return bound_ms(2 * rows * n_pr * n * 4, ntt_ops(rows, n_pr, n) + rows * n_pr * n * OPS_MULMOD)


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
    from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
    from tfhe_tpu_torch.models import boolean as bo
    from tfhe_tpu_torch.models import glwe_matmul as gm
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
    LOOP = tp.PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128
    BOOL = tp.BOOLEAN_PARAMS_128
    MM = tp.PARAMS_8B_2048
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # -- build ----------------------------------------------------------------
    build_s = _build.build_all()

    def ptxas_of(name):
        log = _build.log_path(name)
        return [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
                if "registers" in ln or "Compiling entry" in ln or "spill" in ln]

    print(f"build_s: {build_s:.3f} (" + "; ".join(ln for nm in _build.SOURCES for ln in ptxas_of(nm)) + ")",
          flush=True)

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

    # K1 at the keygen's largest call: a monomial table, 2N small rows
    polys = rand_i32((2 * n, n), -1, 2)
    k1_err = mod_err(eng.forward_small(polys), eng.forward_small_plain(polys))
    check(k1_err == 0, f"K1 vs plain at (2N, N) (err {k1_err})")
    k1_keygen = dict(**kernel_ms(lambda: eng.forward_small(polys), 10, "k1_forward"),
                     plain_ms=cuda_ms(lambda: eng.forward_small_plain(polys), 2),
                     shape=f"({2 * n}, {n}) int32 -> ({2 * n}, {n_pr}, {n})")
    k1_keygen["bound_ms"], k1_keygen["bound_by"] = k1_bound(2 * n, n_pr, n, 4)
    # K1 on u64 rows (forward_u64: GGSW rows of the bootstrap key)
    u = rand_u64((4 * PARAMS.lwe_dimension, n))
    k1u_err = mod_err(eng.forward_u64(u), eng.forward_u64_plain(u))
    check(k1u_err == 0, f"K1 (u64 input) vs plain (err {k1u_err})")
    # K2 at the classic keygen's call: GLWE encryption of the bootstrap key
    rows2 = 2 * PARAMS.lwe_dimension
    f2 = eng.forward_u64(rand_u64((rows2, n)))
    k2_err = exact_err(ntt_cuda.inverse(eng, f2), eng.inverse_plain(f2))
    check(k2_err == 0, f"K2 vs plain at ({rows2}, P, N) (err {k2_err})")
    k2_keygen = dict(**kernel_ms(lambda: ntt_cuda.inverse(eng, f2), 10, "k2_inverse"),
                     plain_ms=cuda_ms(lambda: eng.inverse_plain(f2), 2), shape=f"({rows2}, {n_pr}, {n})")
    k2_keygen["bound_ms"], k2_keygen["bound_by"] = k2_bound(rows2, n_pr, n)
    print(f"check K1 ({2 * n}, {n}) err {k1_err}, u64 ({4 * PARAMS.lwe_dimension}, {n}) err {k1u_err}; "
          f"K2 ({rows2}, {n_pr}, {n}) err {k2_err}", flush=True)
    del x3, x4, f4, polys, u, f2

    # K1 and K2 at the loop path's shapes (PARAM_MESSAGE_1_CARRY_1: k + 1 = 3
    # digit rows per ciphertext at N = 1024, batch 512), then at ragged row
    # counts and the extreme inputs at N = 1024 and 2048
    n11 = LOOP.polynomial_size
    eng11 = get_folded_engine(n11, dev)
    rows11 = BATCH * (LOOP.glwe_dimension + 1) * LOOP.pbs.level
    half = 1 << (LOOP.pbs.base_log - 1)
    digits = rand_i32((BATCH, LOOP.glwe_dimension + 1, n11), -half, half)
    fd = eng11.forward_small(digits)
    k1_loop_err = mod_err(fd, eng11.forward_small_plain(digits))
    mac = (rand_i32((BATCH, LOOP.glwe_dimension + 1, n_pr, n11), 0, 2**31) % (2 * primes)).to(torch.int32)
    k2_loop_err = exact_err(ntt_cuda.inverse(eng11, mac), eng11.inverse_plain(mac))
    check(k1_loop_err == 0 and k2_loop_err == 0,
          f"K1/K2 vs plain at the loop path's shapes (err {k1_loop_err}, {k2_loop_err})")
    k1_loop = dict(**kernel_ms(lambda: eng11.forward_small(digits), 20, "k1_forward"),
                   plain_ms=cuda_ms(lambda: eng11.forward_small_plain(digits), 2),
                   shape=f"({rows11}, {n11}) int32 -> ({rows11}, {n_pr}, {n11})")
    k1_loop["bound_ms"], k1_loop["bound_by"] = k1_bound(rows11, n_pr, n11, 4)
    k2_loop = dict(**kernel_ms(lambda: ntt_cuda.inverse(eng11, mac), 20, "k2_inverse"),
                   plain_ms=cuda_ms(lambda: eng11.inverse_plain(mac), 2), shape=f"({rows11}, {n_pr}, {n11})")
    k2_loop["bound_ms"], k2_loop["bound_by"] = k2_bound(rows11, n_pr, n11)
    del digits, fd, mac
    # K1 and K2 at the shapes the boolean and matmul paths give them (paths 5
    # and 6), timed here, before the first profiler window over a whole path:
    # short profiles taken after one have lost kernel events on the H100
    # the gate step: 9 digit rows per ciphertext, |digit| <= 2^(base_log - 1)
    eng10 = get_folded_engine(BOOL.polynomial_size, dev)
    rows_b = BATCH * (BOOL.glwe_dimension + 1) * BOOL.pbs.level
    half_b = 1 << (BOOL.pbs.base_log - 1)
    digits = rand_i32((rows_b, BOOL.polynomial_size), -half_b, half_b + 1)
    k1_bool_err = mod_err(eng10.forward_small(digits), eng10.forward_i32_plain(digits))
    mac = (rand_i32((BATCH, BOOL.glwe_dimension + 1, n_pr, BOOL.polynomial_size), 0, 2**31) % (2 * primes)).to(torch.int32)
    k2_bool_err = exact_err(ntt_cuda.inverse(eng10, mac), eng10.inverse_plain(mac))
    check(k1_bool_err == 0 and k2_bool_err == 0,
          f"K1/K2 vs plain at the boolean step's shapes (err {k1_bool_err}, {k2_bool_err})")
    k1_bool = dict(**kernel_ms(lambda: eng10.forward_small(digits), 20, "k1_forward"),
                   plain_ms=cuda_ms(lambda: eng10.forward_i32_plain(digits), 2),
                   shape=f"({rows_b}, {BOOL.polynomial_size}) int32 -> ({rows_b}, {n_pr}, {BOOL.polynomial_size})")
    k1_bool["bound_ms"], k1_bool["bound_by"] = k1_bound(rows_b, n_pr, BOOL.polynomial_size, 4)
    rows_m = BATCH * (BOOL.glwe_dimension + 1)
    k2_bool = dict(**kernel_ms(lambda: ntt_cuda.inverse(eng10, mac), 20, "k2_inverse"),
                   plain_ms=cuda_ms(lambda: eng10.inverse_plain(mac), 2),
                   shape=f"({rows_m}, {n_pr}, {BOOL.polynomial_size})")
    k2_bool["bound_ms"], k2_bool["bound_by"] = k2_bound(rows_m, n_pr, BOOL.polynomial_size)
    print(f"check K1 at the boolean step ({rows_b}, {BOOL.polynomial_size}) vs forward_i32_plain err {k1_bool_err}, "
          f"{k1_bool['ms']:.4f} ms (bound {k1_bool['bound_ms']:.4f}, plain {k1_bool['plain_ms']:.4f}); "
          f"K2 ({rows_m}, {n_pr}, {BOOL.polynomial_size}) err {k2_bool_err}, {k2_bool['ms']:.4f} ms; "
          f"{k1_bool['timed_by']}", flush=True)
    del digits, mac
    # K1 at the packing keyswitch's launch (R * n_in * level digit rows) and
    # K2 at the mask inverse (R * O * k rows); the plain versions run in
    # chunks of rows (their float64 digit planes would not fit at once)
    rows_pks = MM_R * MM.glwe_dimension * MM.polynomial_size * MM.packing_ks.level
    half_p = 1 << (MM.packing_ks.base_log - 1)
    digits = rand_i32((rows_pks, n), -half_p, half_p + 1)
    f_k = eng.forward_small(digits)
    k1_pks_err, k1_pks_plain = chunked_vs_plain(eng.forward_small_plain, digits, f_k, 8192, mod_err)
    del f_k
    rows_mask = MM_R * MM_O * MM.glwe_dimension
    mac = (rand_i32((rows_mask, n_pr, n), 0, 2**31) % (2 * primes)).to(torch.int32)
    k2_mask_err, k2_mask_plain = chunked_vs_plain(eng.inverse_plain, mac, ntt_cuda.inverse(eng, mac), 8192, exact_err)
    check(k1_pks_err == 0 and k2_mask_err == 0,
          f"K1 at ({rows_pks}, {n}) and K2 at ({rows_mask}, {n_pr}, {n}) vs plain (err {k1_pks_err}, {k2_mask_err})")
    k1_pks = dict(**kernel_ms(lambda: eng.forward_small(digits), 5, "k1_forward"), plain_ms=k1_pks_plain,
                  shape=f"({rows_pks}, {n}) int32 -> ({rows_pks}, {n_pr}, {n})")
    k1_pks["bound_ms"], k1_pks["bound_by"] = k1_bound(rows_pks, n_pr, n, 4)
    k2_mask = dict(**kernel_ms(lambda: ntt_cuda.inverse(eng, mac), 5, "k2_inverse"), plain_ms=k2_mask_plain,
                   shape=f"({rows_mask}, {n_pr}, {n})")
    k2_mask["bound_ms"], k2_mask["bound_by"] = k2_bound(rows_mask, n_pr, n)
    print(f"check K1 at the packing keyswitch ({rows_pks}, {n}) err {k1_pks_err}, {k1_pks['ms']:.4f} ms "
          f"(bound {k1_pks['bound_ms']:.4f}, plain {k1_pks_plain:.3f}); K2 at the masks ({rows_mask}, {n_pr}, {n}) "
          f"err {k2_mask_err}, {k2_mask['ms']:.4f} ms (bound {k2_mask['bound_ms']:.4f}, plain {k2_mask_plain:.3f}); "
          f"{k1_pks['timed_by']}", flush=True)
    del digits, mac
    edge = {}
    i32_ext = torch.tensor([2**31 - 1, -(2**31) + 1, -(2**31), -1, 0, 1], device=dev, dtype=torch.int32)
    u64_ext = torch.tensor([0, -1, 1, 2**32 - 1, 2**32, -(2**63)], device=dev, dtype=torch.int64)  # -1 is 2^64 - 1
    for e_ in (eng11, eng):
        nn = e_.n
        for rows in (1, 3, 1537):
            if rows == 1537 and nn != n11:
                continue
            xi = rand_i32((rows, nn), -(2**31), 2**31)
            xi[0, :6] = i32_ext
            xu = rand_u64((rows, nn))
            xu[0, :6] = u64_ext
            fi = ntt_cuda.forward(e_, xi, small=True)
            edge[f"N{nn}/{rows}r"] = (
                mod_err(fi, e_.forward_i32_plain(xi)),
                mod_err(ntt_cuda.forward(e_, xu, small=False), e_.forward_u64_plain(xu)),
                exact_err(ntt_cuda.inverse(e_, fi), e_.inverse_plain(fi)),
            )
    check(all(v == (0, 0, 0) for v in edge.values()),
          f"K1 (int32, u64) and K2 vs plain at ragged rows with extreme inputs {edge}")
    print(f"check K1/K2 at the loop shapes ({rows11}, {n11}): err {k1_loop_err}, {k2_loop_err}; "
          f"ragged rows with extreme inputs, (K1 i32, K1 u64, K2) err {edge}", flush=True)
    print("ptxas K1/K2: " + "; ".join(ln for ln in ptxas_of("ntt")), flush=True)

    # K3: one launch of 4 steps, random accumulators and key rows, at ragged
    # batches of 1, 3 and 64 ciphertexts (the grid holds one block per
    # ciphertext and prime), with a = 0 and exponents >= N among the steps
    rot_table = brc.monomial_ntt_table(eng)
    base_log = PARAMS.pbs.base_log
    acc = rand_u64((64, 2, n))
    bsk = rand_key_rows((4, 2, 2))
    k3s_err = {}
    for nb in (1, 3, 64):
        exps = rand_i32((4, nb), 0, 2 * n)
        exps[0, 0], exps[1, nb // 2], exps[2, nb - 1], exps[3, 0] = 0, n, 2 * n - 1, n + 1
        k3s_err[f"{nb}ct"] = exact_err(
            brc.cmux_steps(acc[:nb], exps, bsk, rot_table, eng, base_log, 11),
            brc.cmux_steps_plain(acc[:nb], exps, bsk, rot_table, eng, base_log, 11),
        )
    check(all(e == 0 for e in k3s_err.values()), f"K3 vs plain, 4 steps x 1/3/64 ciphertexts (err {k3s_err})")
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
    print(f"check K3 (4 steps) err by batch {k3s_err}; K4 (4 groups) err by g and batch {k4s_err}", flush=True)

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
    k3_key_bytes = sk.bsk.bsk_ntt.numel() * 4

    def k3_bound(nb):
        return bound_ms(rotation_bytes(nb, steps, k3_key_bytes, 1, n_pr, n), cmux_ops(nb, steps, n_pr, n))

    # a classic PBS of a few ciphertexts launches K3 on a small batch: time 64 and 128 too
    k3_by_batch = {}
    for nb in (64, 128):
        acc_b, e_b = acc0[:nb].contiguous(), e_all[:, :nb].contiguous()
        t_b = cuda_ms(lambda: brc.cmux_steps(acc_b, e_b, *args[2:]), 3)
        k3_by_batch[str(nb)] = dict(zip(("ms", "bound_ms", "bound_by"), (t_b, *k3_bound(nb))))
    b, o = k3_bound(BATCH)
    k3_by_batch[str(BATCH)] = dict(ms=k3_ms, bound_ms=b, bound_by=o)
    kern["K3"] = dict(
        name="cmux_steps", route="cuda", source="tfhe_tpu_torch/csrc/blind_rotate.cu",
        replaces="tfhe_tpu/ops/pallas_blind_rotate.py:279", max_abs_err=max(k3_err, pbs_err, *k3s_err.values()),
        ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=b, bound_by=o, library_ms=None, path="classic",
        shape=f"{BATCH} ct x {steps} steps", ms_by_batch=k3_by_batch,
    )
    print("K3 by batch: " + ", ".join(
        f"{nb} ct {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} by {v['bound_by']})" for nb, v in k3_by_batch.items()
    ), flush=True)
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

    del ck, sk, c, e_bal, e_amt, new_from, new_to

    # -- path 4: the loop PBS at PARAM_MESSAGE_1_CARRY_1 (k=2, N=1024) --------
    # Not level 1 with k = 1, so every PBS takes the loop of external
    # products: K1 on the gadget digits and K2 after the MAC, once per step.
    reset_counts()
    t0 = time.perf_counter()
    ck, sk = si.keygen(LOOP, seed=SEED + 7, device="cuda")
    torch.cuda.synchronize()
    loop_keygen_s = time.perf_counter() - t0
    keygen_counts = read_counts()
    check(not bt.uses_fused_cmux(sk.bsk, LOOP.glwe_dimension + 1), "the 1_1 key takes the loop of external products")
    v2 = torch.arange(BATCH, device=dev) % LOOP.message_modulus
    c = si.encrypt(ck, v2, FheRng(SEED + 8, "cuda"))
    lut_id = si.generate_lut(LOOP, lambda v: v, "cuda")
    lut_flip = si.generate_lut(LOOP, lambda v: (1 - v) % LOOP.message_modulus, "cuda")
    ident = si.apply_lut(sk, c, lut_id, LOOP.message_modulus - 1)
    flip = si.apply_lut(sk, c, lut_flip, LOOP.message_modulus - 1)
    paths["pbs_loop"] = read_counts()
    per_lut = {k: (paths["pbs_loop"][k] - keygen_counts[k]) / 2 for k in wrappers}
    check(bool((si.decrypt(ck, ident) == v2).all()), "pbs_loop: identity LUT decrypts to the inputs")
    check(bool((si.decrypt(ck, flip) == 1 - v2).all()), "pbs_loop: v -> 1 - v decrypts")
    steps11 = LOOP.lwe_dimension
    check(per_lut["K1"] == steps11 and per_lut["K2"] == steps11 and per_lut["K3"] == 0 and per_lut["K4"] == 0,
          f"pbs_loop: K1 and K2 launched {steps11} times per apply_lut, K3/K4 never ({per_lut})")
    print(f"pbs_loop path ({LOOP.name}, n={steps11}, k={LOOP.glwe_dimension}, N={n11}, "
          f"PBS level {LOOP.pbs.level} / base_log {LOOP.pbs.base_log}): keygen_s {loop_keygen_s:.3f}; "
          f"{BATCH} ct identity/1-v decrypt ok; launches {paths['pbs_loop']} (keygen {keygen_counts}, "
          f"per apply_lut {per_lut})", flush=True)

    loop_ms = cuda_ms(lambda: si.apply_lut(sk, c, lut_flip, 1), 2)
    small = keyswitch(c.ct, sk.ksk)
    rot_ms = cuda_ms(lambda: bt.blind_rotate(lut_flip, small, sk.bsk, eng11), 1)
    step_ms = rot_ms / steps11
    share = (k1_loop["ms"] + k2_loop["ms"]) / step_ms
    print(f"pbs_loop: batch {BATCH}, {loop_ms:.3f} ms per apply_lut, {BATCH / loop_ms * 1e3:.1f} PBS/s; "
          f"blind rotation {rot_ms:.3f} ms, {step_ms:.4f} ms per rotation step; "
          f"K1 {k1_loop['ms']:.4f} ms (bound {k1_loop['bound_ms']:.4f}, wrapper {k1_loop['wrapper_ms']:.4f}), "
          f"K2 {k2_loop['ms']:.4f} ms (bound {k2_loop['bound_ms']:.4f}, wrapper {k2_loop['wrapper_ms']:.4f}) "
          f"at the step's shapes, {k1_loop['timed_by']}: {100 * share:.1f} % of a step", flush=True)

    # kernel time by name over one apply_lut, where the profiler sees the card
    profile_window("pbs_loop", "one apply_lut", lambda: si.apply_lut(sk, c, lut_flip, 1), steps11, loop_ms)
    del ck, sk, c, ident, flip, small
    # -- path 5: boolean gates at BOOLEAN_PARAMS_128 (k=2, N=1024, level 3) ---
    # Every gate bootstrap takes the loop of external products: K1 on the
    # (k+1) * level = 9 digit rows of each ciphertext and K2 once per step.
    reset_counts()
    t0 = time.perf_counter()
    bck, bsk = bo.keygen(BOOL, seed=SEED + 9, device="cuda")
    torch.cuda.synchronize()
    bool_keygen_s = time.perf_counter() - t0
    check(not bt.uses_fused_cmux(bsk.bsk, BOOL.glwe_dimension + 1), "the boolean key takes the loop of external products")
    idx = torch.arange(BATCH, device=dev)
    bits = {"a": idx % 2, "b": (idx // 2) % 2, "c": (idx // 4) % 2}  # every input combination, 128 (64) times
    brng = FheRng(SEED + 10, "cuda")
    ea, eb, ec = (bo.encrypt(bck, bits[k], brng) for k in ("a", "b", "c"))
    truth = {
        "and_": bits["a"] & bits["b"], "or_": bits["a"] | bits["b"], "nand": 1 - (bits["a"] & bits["b"]),
        "nor": 1 - (bits["a"] | bits["b"]), "xor_": bits["a"] ^ bits["b"], "xnor": 1 - (bits["a"] ^ bits["b"]),
        "not_": 1 - bits["a"], "mux": torch.where(bits["c"] == 1, bits["a"], bits["b"]),
    }
    bootstraps = {"not_": 0, "mux": 3}
    steps_b = BOOL.lwe_dimension
    per_gate = {}
    for gate in truth:
        before = read_counts()
        if gate == "not_":
            out = bo.not_(bsk, ea)
        elif gate == "mux":
            out = bo.mux(bsk, ec, ea, eb)
        else:
            out = getattr(bo, gate)(bsk, ea, eb)
        after = read_counts()
        per_gate[gate] = {k: after[k] - before[k] for k in wrappers}
        check(bool((bo.decrypt(bck, out).to(torch.int64) == truth[gate]).all()), f"boolean: {gate} decrypts to its truth table")
        nb = bootstraps.get(gate, 1)
        check(per_gate[gate] == {"K1": steps_b * nb, "K2": steps_b * nb, "K3": 0, "K4": 0},
              f"boolean: {gate} launches K1 and K2 {steps_b} times per bootstrap ({nb}), K3/K4 never ({per_gate[gate]})")
    paths["boolean"] = read_counts()
    print(f"boolean path ({BOOL.name}, n={steps_b}, k={BOOL.glwe_dimension}, N={BOOL.polynomial_size}, "
          f"PBS level {BOOL.pbs.level} / base_log {BOOL.pbs.base_log}): keygen_s {bool_keygen_s:.3f}; "
          f"{BATCH} ct, six gates, not_ and mux decrypt to their truth tables; launches {paths['boolean']} "
          f"(per gate {per_gate})", flush=True)

    and_ms = cuda_ms(lambda: bo.and_(bsk, ea, eb), 2)
    print(f"boolean: batch {BATCH}, AND {and_ms:.3f} ms per gate batch, {BATCH / and_ms * 1e3:.1f} gates/s, "
          f"{and_ms / steps_b:.4f} ms per rotation step", flush=True)
    print(f"boolean: {k1_bool['timed_by']}: K1 + K2 at the step's shapes "
          f"{100 * (k1_bool['ms'] + k2_bool['ms']) / (and_ms / steps_b):.1f} % of a step", flush=True)
    profile_window("boolean", "one AND gate batch", lambda: bo.and_(bsk, ea, eb), steps_b, and_ms)
    del bck, bsk, ea, eb, ec, out

    # -- path 6: encrypted x clear matmul at PARAMS_8B_2048 ------------------
    # enc(32 x 2048) x clear(2048 x 1024), 8-bit inputs, weights in [-7, 7]
    reset_counts()
    t0 = time.perf_counter()
    mkey = gm.create_private_key(MM, seed=3, device="cuda")
    torch.cuda.synchronize()
    mm_keygen_s = time.perf_counter() - t0
    host = np.random.default_rng(11)
    x_in = host.integers(0, 1 << 8, (MM_R, MM_C), dtype=np.uint64)
    w_in = host.integers(-7, 8, (MM_C, MM_O), dtype=np.int64)
    t0 = time.perf_counter()
    enc = gm.encrypt_matrix(mkey, x_in, FheRng(7, "cuda"))
    torch.cuda.synchronize()
    mm_encrypt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = gm.prepare_clear_weights(MM, w_in, device="cuda")
    torch.cuda.synchronize()
    mm_prepare_s = time.perf_counter() - t0
    res = gm.matrix_multiplication(enc, prep, mkey)
    before = read_counts()
    res = gm.matrix_multiplication(enc, prep, mkey)
    after = read_counts()
    per_mm = {k: after[k] - before[k] for k in wrappers}
    raw = gm.matrix_multiplication(enc, w_in, mkey)
    paths["matmul"] = read_counts()
    got = gm.decrypt_matrix(res, mkey).cpu().numpy()
    err = (got - x_in.astype(np.int64) @ w_in).astype(np.float64)
    err_std, err_max = float(err.std()), int(np.abs(err).max())
    check(err_max <= 256, f"matmul: max |decrypted - clear product| {err_max} within the budget of 256")
    check(torch.equal(raw.data, res.data), "matmul: the raw-weight path equals the prepared path")
    check(per_mm == {"K1": 2, "K2": 2, "K3": 0, "K4": 0},
          f"matmul: K1 2 and K2 2 launches per matmul on prepared weights, K3/K4 none ({per_mm})")
    mm_ms = cuda_ms(lambda: gm.matrix_multiplication(enc, prep, mkey), 3)
    gmacs = MM_R * MM_C * MM_O / (mm_ms * 1e-3) / 1e9
    print(f"matmul ({MM.name}, N={MM.polynomial_size}, enc({MM_R}x{MM_C}) x clear({MM_C}x{MM_O})): "
          f"keygen_s {mm_keygen_s:.3f}, encrypt_s {mm_encrypt_s:.3f}, prepare_s {mm_prepare_s:.3f}; "
          f"{mm_ms:.3f} ms per matmul on prepared weights, {gmacs:.3f} Gmac/s; err_std {err_std:.4f}, "
          f"err_max {err_max} (budget 256); launches {paths['matmul']} (per matmul {per_mm})", flush=True)
    print(f"matmul: {k1_pks['timed_by']}: K1 at the packing keyswitch + K2 at the masks "
          f"{100 * (k1_pks['ms'] + k2_mask['ms']) / mm_ms:.1f} % of a matmul", flush=True)
    profile_window("matmul", "one matmul on prepared weights", lambda: gm.matrix_multiplication(enc, prep, mkey),
                   None, mm_ms)
    del mkey, enc, prep, res, raw

    # -- path 7: the encrypted linear layer, 2048 -> 1024, batch 32 -----------
    reset_counts()
    host = np.random.default_rng(12)
    layer = GlweLinearLayerExecutor(host.normal(size=(MM_C, MM_O)), bias=host.normal(size=MM_O))
    t0 = time.perf_counter()
    layer.keygen(seed=5, device="cuda")
    torch.cuda.synchronize()
    lin_keygen_s = time.perf_counter() - t0
    x_f = host.uniform(-1.0, 3.0, size=(MM_R, MM_C))
    t0 = time.perf_counter()
    y_exec = layer.forward(x_f, fhe="execute")
    lin_ms = (time.perf_counter() - t0) * 1e3
    paths["linear"] = read_counts()
    y_clear = layer.forward(x_f, fhe="disable")
    lsb = float(layer.last_input_quantizer.scale) * float(layer.w_quant.scale)
    lin_lsb = float(np.abs(y_exec - y_clear).max() / lsb)
    check(np.isfinite(y_exec).all() and y_exec.shape == (MM_R, MM_O), "linear: finite (32, 1024) output")
    check(lin_lsb <= 256, f"linear: EXECUTE within 256 accumulator LSBs of DISABLE ({lin_lsb:.3f})")
    check(paths["linear"]["K1"] > 0 and paths["linear"]["K2"] > 0, f"linear: K1 and K2 launched {paths['linear']}")
    print(f"linear: GlweLinearLayerExecutor {MM_C} -> {MM_O}, batch {MM_R}, {layer.params.name}: keygen_s "
          f"{lin_keygen_s:.3f}; forward EXECUTE {lin_ms:.3f} ms (quantize, encrypt, prepare, matmul, decrypt); "
          f"max |EXECUTE - DISABLE| {lin_lsb:.3f} accumulator LSBs (budget 256); launches {paths['linear']}",
          flush=True)
    del layer

    kern["K1"] = dict(
        name="ntt_forward", route="cuda", source="tfhe_tpu_torch/csrc/ntt.cu",
        replaces="tfhe_tpu/ops/pallas_ntt.py:494", max_abs_err=max(e3, e4, k1_err, k1u_err, k1_loop_err,
                                                                   k1_bool_err, k1_pks_err,
                                                                   *(v[0] for v in edge.values()),
                                                                   *(v[1] for v in edge.values())),
        path="pbs_loop", ms_by_shape={"keygen": k1_keygen, "pbs_loop": k1_loop, "boolean": k1_bool,
                                      "matmul_pks": k1_pks}, **{
            f: k1_loop[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")}, library_ms=None,
    )
    kern["K2"] = dict(
        name="ntt_inverse", route="cuda", source="tfhe_tpu_torch/csrc/ntt.cu",
        replaces="tfhe_tpu/ops/pallas_ntt.py:518",
        max_abs_err=max(k2_512, k2_err, k2_loop_err, k2_bool_err, k2_mask_err, *(v[2] for v in edge.values())),
        path="pbs_loop", ms_by_shape={"keygen": k2_keygen, "pbs_loop": k2_loop, "boolean": k2_bool,
                                      "matmul_mask": k2_mask}, **{
            f: k2_loop[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")}, library_ms=None,
    )

    # -- summary ----------------------------------------------------------------
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "equal", "ms",
             "plain_ms", "plain_shape", "bound_ms", "bound_by", "library_ms", "path", "launches_by_path", "shape",
             "ms_by_batch", "ms_by_shape")
    kern = dict(sorted(kern.items()))
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

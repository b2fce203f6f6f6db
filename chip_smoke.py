#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tfhe_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from tfhe_tpu_torch/csrc with nvcc and
holds each kernel against its plain PyTorch version on the card at the
shapes the main paths give it (bit-exact; the forward NTT mod p; K1 and
K2 also at the loop path's shapes, at ragged row counts of 1, 3 and 1537
with the extreme int32 and u64 inputs, at N = 1024 and 2048, and at the
compact-PKE public key's (1152, 1, 1024) u64 masks; K3 and K4
also at ragged batches of 1, 3 and 64 ciphertexts). First it holds the
port's FheRng (JAX's threefry2x32) on the card against the CPU: from one
seed, after a split and a fork, uniform_torus, binary and tuniform(17),
tuniform(61) draw the same 2^20 values each (`rng:` line). Then it runs
itself with --four-prime in a child process under TFHE_TPU_PRIMES=4 (the
JAX package's process-level prime switch): K1-K4 launched at P = 4, the
4-prime CRT set FOLDED_PRIMES_4, held against their plain versions bit
for bit (K1 and K2 at the keygen's shapes and at ragged rows with extreme
inputs, K3 and K4 at 1, 3 and 64 ciphertexts and on the first 8
ciphertexts of their paths), the clusters of 4 blocks the card holds at
once, and, counts reset before each, the 2_2 keygen (K1, K2) with
apply_lut on 512 ciphertexts (K3) and the GROUP_3 keygen with apply_lut on
512 (K4), decrypted, with the keys' msb (55) and bytes (`four_prime:`
lines); the parent prints each P = 4 kernel time beside the same kernel's
P = 3 time of this run, and the four P = 4 entries join the kernels line.
Next it runs itself with --parallel in a child process (`parallel:`
lines; the path is counted as `parallel`): parallel/ on torch.distributed
at PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128, batch 64. (a)
make_sharded_pbs_step on make_mesh(1, 1), a world of one rank under NCCL
in the child, counts reset before its first run: exactly 880 K1 and 880
K2, no K3/K4; bit-equal to a single-process loop of external products
over the same key, decrypting as apply_lut (K3) does; K1 at the step's
(128, 2048) digits and K2 at its (128, 3, 2048) all-reduced residues
against their plain versions, timed. Then one spawned world of 2 ranks
on the one card under gloo (NCCL refuses two ranks on one device; a
correctness run, not a scaling figure), laid out as one rank a host: (b)
the step at model width 2, bit-equal to (a); (c) make_sharded_ntt at
N = 2048 and 4096, equal mod p to K1's forward_u64, and its round trip;
(d) make_key_sharded_blind_rotate bit-equal to (a)'s rotation; (e)
make_multihost_pbs_step with no byte crossing a host, and the step on the
cross-host model mesh, whose all-reduces cross. It prints ms per sharded
batch at world 1 and 2, collective bytes and ms per step, K1/K2 launches
and the collectives gloo staged through host memory.
Then it drives, through the entry points a user calls, at full width:

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
   EXECUTE within 256 accumulator LSBs of DISABLE (`linear:` line);
8. the fhevm API surface (`api_phase`): create_instance() on the card
   (GROUP_3, PKE_PARAMS_2M128 behind it; no key cache file read or
   written), an FheServer on 127.0.0.1:0 driven by the port's FheClient:
   /health, /publickey,
   /keyurl, two /input-proof requests of 32 euint64 values each (compact-PKE
   lists with ZK proofs, 2048 bits, the CRS's full size), one batched
   /evaluate of an ERC20 transfer per pair (le, select against an encrypted
   0, sub, add), /allow, a KMS-verified /public-decrypt, /user-decrypt
   sealed to an ML-KEM key from generate_keypair, /verify; every value
   checked against numpy, K4 launched on /evaluate and K3 not; ms per
   request and K1-K4 launches per route, the ZK prove and verify seconds
   (`api:` lines);
9. the ML stack (`ml_phase`): the full-FHE stroke classifier of
   examples/fhe_digits_demo.py at PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
   (conv2d_as_linear -> FheTlu -> FheLinear over 32 images: the TLU layer is
   864 PBS in exactly one K3 launch; the scores equal clear_forward,
   accuracy >= 0.9; ms per run and per layer, `ml_fhe:` line; K3 at the
   layer's 864 ciphertexts against its plain version on 64 of them, past
   index 512), and compile_torch_model of a 784 -> 128 -> 128 -> 10 MLP
   with its matmul keys on the card at PARAMS_8B_2048,
   forward(fhe="execute") on 32 rows (exactly 7 K1 and 4 K2 per Gemm,
   K3/K4 none; every K1/K2 call of a forward against its plain version;
   every Gemm within 256 accumulator LSBs of DISABLE; ms per forward,
   `ml_qm:` lines);
10. the ML deployment side (`ml_deploy_phase`): the same MLP's layers 0 and
   2 served at PARAMS_8B_2048 by a HybridFHEModelServer behind
   HybridHTTPServer on 127.0.0.1:0 to a RemoteHybridModel over
   HTTPTransport, batch 32 (rel err < 0.25 against the float forward, each
   remote layer within 256 accumulator LSBs of the clear product, exactly
   7 K1 and 4 K2 per remote layer per forward and no K3/K4, every K1/K2
   call of a remote forward against its plain version, one /compute under
   device_trace naming k1_forward, an in-process HybridFHEModel within 256
   LSBs per layer, counted as a path of its own; ms per forward and per /compute, the /add_key blob's
   bytes and ms, /get_client, the evaluation key's deserialization,
   `hybrid:` lines), LoRA training of the same MLP with FHE base layers (2
   EXECUTE steps: finite losses, lora_b moved, 7 K1 and 4 K2 per base
   layer per step, `lora:` line), and an encrypted left merge of 32 x 32
   rows at the GROUP_3 key (every value equal to numpy's merge, K4 and not
   K3, save -> load, K4's output at the merge's first call of each batch
   size against its plain version on the same inputs, `pandas:` line).

The launch counts are set to 0 just before each path and read just
after it; the kernel-vs-plain comparisons run outside those windows. Each
profiler window runs its call once under a warm-up step first and sums
only the device events issued inside the recorded call. It
prints the card, build time, per-kernel times beside their bounds,
keygen seconds, PBS/s, transfers/s, gates/s, ms per matmul and Gmac/s,
ms per encrypted inference, K3's times at 64, 128, 512 and 864
ciphertexts and K4's at 64, 128 and 512 (`ms_by_batch`), K1's and K2's at the keygen, loop, boolean
and matmul shapes (`ms_by_shape`),
ptxas's registers and spills, a `{"kernels": [...]}` line, and last a
`{"ok": true, "device": {...}}` line. Any failure raises and exits
non-zero; with no CUDA device it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED = 1234
BATCH = 512
ERC20_BATCH = 32
ERC20_BITS = 64
API_USER_HANDLES = 4  # balances decrypted through /user-decrypt's threshold protocol
MM_R, MM_C, MM_O = 32, 2048, 1024  # enc(R x C) x clear(C x O), scripts/bench_matmul.py's shape
ML_BATCH = 32  # images of the full-FHE classifier, rows of the compiled MLP's forward
MERGE_ROWS = 32  # rows of each side of the encrypted dataframe merge
RNG_VALUES = 1 << 20  # values of each sampler in the card-vs-CPU RNG check
P4_PLAIN_CT = 8  # ciphertexts of the 4-prime paths held against K3's and K4's plain versions
PAR_BATCH = 64  # ciphertexts of the parallel path's sharded PBS batch
PAR_WORLD = 2  # ranks of the parallel path's gloo world on the one card
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
    and K2's share, printed as `<label> profile:` lines. A schedule with one
    warm-up step runs `fn` once under the started tracer before the
    recorded call: a window without it lost its first kernel (a matmul's
    window recorded 1 of its 2 K1 launches). The recorded call runs inside
    a `window` range, and a device event counts only when the runtime call
    that issued it (the same correlation id) ran inside that range on the
    host's clock: a rule on the device events' own timestamps let a few
    kernels from outside the call in (785 K1 in a window of 780)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        with record_function("window"):
            fn()
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    events = prof.events()
    win = [ev for ev in events if ev.name == "window" and str(ev.device_type).endswith("CPU")]
    if len(win) != 1:
        print(f"{label} profile: torch.profiler recorded {len(win)} `window` ranges, not 1; no breakdown", flush=True)
        return {}
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    # the runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...) made inside
    # the window, by correlation id
    issued = {ev.id for ev in events if str(ev.device_type).endswith("CPU") and ev.name.startswith("cu")
              and w0 <= ev.time_range.start <= w1}
    by_name, by_op = {}, {}
    for ev in events:
        # the range annotations (ours and the schedule's step) span the
        # window's kernels on both the host and the device timelines
        if ev.name == "window" or ev.name.startswith("ProfilerStep"):
            continue
        on_device = str(ev.device_type).endswith("CUDA")
        us = self_device_us(ev)
        # kernels (device-side events) by name; the torch ops that launched
        # them report the same time, kept apart as the breakdown by op
        if us > 0 and (ev.id in issued if on_device else w0 <= ev.time_range.start <= w1):
            t, cnt = (by_name if on_device else by_op).get(ev.name, (0.0, 0))
            (by_name if on_device else by_op)[ev.name] = (t + us / 1e3, cnt + 1)
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


def ntt_calls_vs_plain(run) -> dict:
    """Run `run()` with K1's and K2's wrappers recording their calls, and
    hold the kernel's output of each distinct call (kernel, input type,
    shape) against its plain version on the same input, in chunks of rows:
    {call: [largest error, calls]} (K1 mod p; K2 exactly)."""
    import torch

    from tfhe_tpu_torch.ops import ntt_cuda

    fwd, inv = ntt_cuda.forward, ntt_cuda.inverse
    seen = {}

    def mod_err(engine):
        primes = torch.tensor(engine.primes, device="cuda").view(1, -1, 1)
        return lambda a, b: int(((a.to(torch.int64) % primes) - (b.to(torch.int64) % primes)).abs().max())

    def exact_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def record(key, x, out, plain, err_fn, row_dims):
        if key not in seen:
            rows = x.reshape(-1, *x.shape[-row_dims:])
            seen[key] = [chunked_vs_plain(plain, rows, out.reshape(-1, *out.shape[-2:]), 8192, err_fn)[0], 0]
        seen[key][1] += 1

    def forward(engine, x, small):
        out = fwd(engine, x, small)
        plain = engine.forward_i32_plain if small else engine.forward_u64_plain
        record(f"K1 {'int32' if small else 'u64'} {tuple(x.shape)}", x, out, plain, mod_err(engine), 1)
        return out

    def inverse(engine, f):
        out = inv(engine, f)
        record(f"K2 {tuple(f.shape)}", f, out, engine.inverse_plain, exact_err, 2)
        return out

    # the wrappers count on the module's names, so the recorders take the
    # counts while they stand in, and hand them back after
    forward.launches, inverse.launches = 0, 0
    ntt_cuda.forward, ntt_cuda.inverse = forward, inverse
    try:
        run()
    finally:
        ntt_cuda.forward, ntt_cuda.inverse = fwd, inv
        fwd.launches += forward.launches
        inv.launches += inverse.launches
    return seen


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


def api_phase(dev, read_counts) -> dict:
    """The fhevm serving flow through the port's API surface: create_instance
    (GROUP_3 with PKE_PARAMS_2M128 behind it; the key cache untouched), an
    FheServer on 127.0.0.1:0 driven by the port's FheClient: /health,
    /publickey, /keyurl, two /input-proof requests of ERC20_BATCH values each
    (balances, amounts; compact-PKE lists with ZK proofs), one batched
    /evaluate of an ERC20 transfer per pair (le, select against an encrypted
    0, sub, add), /allow, a KMS-verified /public-decrypt of the new balances,
    /user-decrypt sealed to an ML-KEM key from generate_keypair, /verify.
    Every decrypted value is checked against numpy. Returns the seconds,
    per-route ms and per-route kernel launches (K1-K4 from `read_counts`)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.api import compact_pke as cp
    from tfhe_tpu_torch.api import kms, zkpok
    from tfhe_tpu_torch.api import secp256k1 as ec
    from tfhe_tpu_torch.api.client import FheClient
    from tfhe_tpu_torch.api.handles import FhevmHandle
    from tfhe_tpu_torch.api.instance import create_instance
    from tfhe_tpu_torch.api.serve import FheServer
    from tfhe_tpu_torch.api.types import FHE_TYPES
    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.rng import FheRng
    from tfhe_tpu_torch.utils import keycache, serialization

    out = {"routes": {}}

    def timed(route, fn):
        """Run one request; record its ms and the kernel launches it made
        (summed over the route's requests)."""
        before = read_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        r = out["routes"].setdefault(route, {"requests": 0, "ms": 0.0, "launches": {k: 0 for k in after}})
        r["requests"] += 1
        r["ms"] += ms
        for k in after:
            r["launches"][k] += after[k] - before[k]
        return res

    # on the card keygen is the warm start: the GROUP_3 key pair (~2.4 GB
    # serialized) is neither read from nor written to the key cache
    key_file = keycache.cache_path(tp.PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128, SEED + 11, None)
    check(not os.path.exists(key_file), f"api: no key cache file before create_instance() ({key_file})")
    t0 = time.perf_counter()
    inst = create_instance(seed=SEED + 11, device=dev)
    torch.cuda.synchronize()
    out["keygen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pke = inst.pke_keys
    torch.cuda.synchronize()
    out["pke_keygen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    crs = inst.crs
    out["crs_s"] = time.perf_counter() - t0
    out["params"], out["pke_params"] = inst.params.name, pke.params.name
    check(not os.path.exists(key_file), f"api: create_instance() on the card wrote no key cache file ({key_file})")
    p = inst.params
    C, U = "0x" + "c0" * 20, "0x" + "a1" * 20
    pairs, bits = ERC20_BATCH, ERC20_BITS
    t = FHE_TYPES[f"euint{bits}"]
    host = np.random.default_rng(21)
    mask = (1 << bits) - 1
    bal = host.integers(0, 1 << (bits // 2), pairs, dtype=np.uint64)
    amt = host.integers(0, 1 << (bits // 2 + 1), pairs, dtype=np.uint64)  # some overdraw
    srv = FheServer(inst).start()
    try:
        cl = FheClient(f"http://127.0.0.1:{srv.port}", timeout=900.0)
        check(timed("/health", cl.health)["status"] == "ok", "api: /health")
        pk = timed("/publickey", cl.get_public_key)
        check(pk["paramsHash"] == p.hash and len(pk["publicKey"]) > 0, "api: /publickey")
        check(timed("/keyurl", lambda: cl._get("/keyurl"))["response"]["fhe_key_info"][0]["params_hash"] == p.hash,
              "api: /keyurl")

        def submit(values, seed):
            """Client side of an input: the builder's block values, the
            compact-PKE list and its ZK proof; then one /input-proof."""
            b = inst.create_encrypted_input(C, U)
            for v in values:
                b._add(t.name, int(v))
            blocks, _ = b._block_values()
            aux = inst.input_aux_data(C, U)
            t0 = time.perf_counter()
            lst, r, e = cp.compact_pke_encrypt_with_witness(pke, blocks, FheRng(seed, dev))
            torch.cuda.synchronize()
            out.setdefault("encrypt_s", []).append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            proof = zkpok.prove(crs, pke.pke_pk, lst, r, np.asarray(blocks, dtype=np.uint64), e, aux)
            out.setdefault("prove_s", []).append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            zkpok.verify(crs, pke.pke_pk, lst, proof, aux)  # what the server does first, timed alone
            out.setdefault("verify_s", []).append(time.perf_counter() - t0)
            body = {"ciphertext": serialization.serialize(lst).hex(), "zkProof": proof.to_bytes().hex(),
                    "types": [t.name] * len(values), "contract": C, "user": U}
            out.setdefault("proof_bytes", len(proof.to_bytes()))
            resp = timed("/input-proof", lambda: cl._post("/input-proof", body))
            check(len(resp["handles"]) == len(values) and len(resp["signatures"]) >= resp["threshold"],
                  "api: /input-proof returns one handle a value and a quorum of signatures")
            return resp

        rb, ra = submit(bal, SEED + 12), submit(amt, SEED + 13)
        out["input_bits"] = pairs * bits
        check(timed("/verify", lambda: cl._post("/verify", {"handles": rb["handles"], "inputProof": rb["inputProof"],
                                                             "user": U, "contract": C}))["valid"],
              "api: /verify accepts the balances' input proof")

        # the transfer list: later ops name earlier results by their
        # deterministic handles, and /evaluate runs it in dependency waves
        def h_of(op, operands, tname):
            return FhevmHandle.from_op(op, [bytes.fromhex(x[2:]) for x in operands], inst.chain_id,
                                       FHE_TYPES[tname].type_id).hex()

        zero = h_of("xor", [ra["handles"][0]] * 2, t.name)
        ops = [("xor", [ra["handles"][0]] * 2)]
        new_from, new_to = [], []
        for hb, ha in zip(rb["handles"], ra["handles"]):
            cond = h_of("le", [ha, hb], "ebool")
            moved = h_of("select", [cond, ha, zero], t.name)
            ops += [("le", [ha, hb]), ("select", [cond, ha, zero]), ("sub", [hb, moved]), ("add", [hb, moved])]
            new_from.append(h_of("sub", [hb, moved], t.name))
            new_to.append(h_of("add", [hb, moved], t.name))
        res = timed("/evaluate", lambda: cl.evaluate_many(ops))
        check(res["handles"][3::4] == new_from and res["handles"][4::4] == new_to,
              "api: /evaluate returns the handles the client derived")
        check(res["batchedGroups"] == 4 and res["singleOps"] == 1,
              f"api: /evaluate ran le, select, sub, add as 4 batched groups and the zero alone ({res})")
        out["evaluate"] = {k: res[k] for k in ("gasUsed", "batchedGroups", "singleOps")}
        out["ops"] = len(ops)

        moved_np = np.where(amt <= bal, amt, 0)
        want_from = [int(x) for x in (bal - moved_np) & mask]
        want_to = [int(x) for x in (bal + moved_np) & mask]
        for h in new_from + new_to:
            timed("/allow", lambda: cl.allow(h))
        dec = timed("/public-decrypt", lambda: cl.public_decrypt_verified(new_from + new_to))["values"]
        check([int(dec[h]) for h in new_from] == want_from and [int(dec[h]) for h in new_to] == want_to,
              "api: /public-decrypt (KMS-verified) gives bal - moved and bal + moved")

        # user decrypt: EIP-712-signed request, shares sealed to the user's
        # ML-KEM key, combined by the client
        user_priv = ec.keygen(b"api-user")
        user = ec.address(user_priv)
        asked = new_from[:API_USER_HANDLES]
        for h in asked:
            for acct in (user, C):
                timed("/allow", lambda: cl.allow(h, account=acct, for_decryption=False))
        kp = inst.generate_keypair()
        ek, dk = bytes.fromhex(kp["publicKey"]), bytes.fromhex(kp["privateKey"])
        info = timed("/kms-info", cl.kms_info)
        start = int(time.time()) - 60
        sig = ec.sign(user_priv, kms.user_decrypt_request_digest(ek, [C], info["chainId"], start, 1,
                                                                 info["verifyingContract"]))
        body = {"handleContractPairs": [{"handle": h, "contractAddress": C} for h in asked], "userAddress": user,
                "publicKey": ek.hex(), "signature": sig.hex(), "contractAddresses": [C], "startTimestamp": start,
                "durationDays": 1}
        resp = timed("/user-decrypt", lambda: cl._post("/user-decrypt", body))
        t0 = time.perf_counter()
        items = [{"handle": bytes.fromhex(i["handle"][2:]),
                  "blocks": np.frombuffer(bytes.fromhex(i["blocks"]), dtype=np.uint64).reshape(i["shape"]),
                  "type": i["type"], "bits": i["bits"]} for i in resp["items"]]
        got = kms.process_user_decrypt_response(resp["responses"], dk, items, resp["kmsSigners"], resp["threshold"],
                                                info["delta"], info["plaintextModulus"], bytes.fromhex(resp["nonce"]),
                                                info["bitsPerBlock"])
        out["user_decrypt_client_s"] = time.perf_counter() - t0
        check(got == want_from[:API_USER_HANDLES], "api: /user-decrypt unseals and combines to bal - moved")
        out["user_handles"] = len(asked)
    finally:
        srv.stop()
    return out


def mnist_mlp(seed: int = SEED):
    """The MNIST-width MLP of the ML phases: 784 -> 128 -> 128 -> 10, ReLU,
    torch init from `seed`."""
    import torch

    nn = torch.nn
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(784, 128), nn.ReLU(), nn.Linear(128, 128), nn.ReLU(), nn.Linear(128, 10))


def make_strokes(n_per_class: int, rng):
    """5x5 images, pixel values in [0, 3]: a full-intensity stroke over 0/1
    speckle noise. Classes: horizontal bar, vertical bar, diagonal (the
    data of examples/fhe_digits_demo.py)."""
    import numpy as np

    X, y = [], []
    for cls in range(3):
        for _ in range(n_per_class):
            img = rng.integers(0, 2, (5, 5))
            pos = rng.integers(1, 4)
            if cls == 0:
                img[pos, :] = 3
            elif cls == 1:
                img[:, pos] = 3
            else:
                for i in range(5):
                    img[i, i] = 3
            X.append(img)
            y.append(cls)
    return np.array(X), np.array(y)


def ml_phase(dev, reset_counts, read_counts) -> dict:
    """The ML stack's two encrypted paths, the launch counts reset before
    each and read after it:

    ml_fhe: the full-FHE stroke classifier of examples/fhe_digits_demo.py
    (conv2d_as_linear of three 3x3 kernels over 5x5 images, FheTlu(fires),
    a 27 -> 3 FheLinear head) at PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128:
    keygen, encrypt ML_BATCH images, run, decrypt; the scores equal
    clear_forward and the accuracy is >= 0.9; the TLU layer is
    ML_BATCH x 27 PBS in one K3 launch, and the run launches no K1, K2, K4;
    K3 at that shape equals its plain version on 64 of the ciphertexts.

    ml_qm: compile_torch_model of an MNIST-width MLP (784 -> 128 -> 128 ->
    10, ReLU, n_bits 6, torch init from SEED, calibrated on 256 seeded
    inputs), compile() with the matmul keys on the card at PARAMS_8B_2048,
    forward(fhe="execute") on ML_BATCH inputs after a warm-up forward: 7 K1
    and 4 K2 launches per Gemm, no K3 or K4 (counted over the forward alone),
    each K1/K2 call of a forward equal to its plain version, every
    QuantizedGemm's EXECUTE
    output within 256 accumulator LSBs of its DISABLE output on the same
    layer input."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import _u64
    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.core.lwe import keyswitch, lwe_add_plain, sample_extract
    from tfhe_tpu_torch.ml import FheMode, QuantizedGemm, compile_torch_model
    from tfhe_tpu_torch.ml.fhe_pipeline import FheLinear, FheSequential, FheTlu, conv2d_as_linear
    from tfhe_tpu_torch.models.shortint import engine_for
    from tfhe_tpu_torch.ops import blind_rotate_cuda as brc
    from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate

    out = {}
    # -- ml_fhe -----------------------------------------------------------------
    P = tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    kern = np.zeros((3, 1, 3, 3), dtype=np.int64)
    kern[0, 0, 1, 0] = kern[0, 0, 1, 2] = 1  # horizontal pair
    kern[1, 0, 0, 1] = kern[1, 0, 2, 1] = 1  # vertical pair
    kern[2, 0, 0, 0] = kern[2, 0, 2, 2] = 1  # diagonal pair
    head = FheLinear(np.kron(np.eye(3, dtype=np.int64), np.ones((9, 1), dtype=np.int64)))
    layers = [conv2d_as_linear(kern, in_hw=(5, 5)), FheTlu(lambda v: 1 if v >= 5 else 0), head]
    rng = np.random.default_rng(SEED)
    X, y = make_strokes(-(-ML_BATCH // 3), rng)
    keep = rng.permutation(len(y))[:ML_BATCH]
    X, y = X[keep].reshape(ML_BATCH, -1), y[keep]

    reset_counts()
    t0 = time.perf_counter()
    net = FheSequential(layers, P, seed=SEED + 20, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    net.compile(input_hi=3)
    enc = net.encrypt(X, seed=SEED + 21)
    before = read_counts()
    res = net.run(enc)
    run_counts = {k: v - before[k] for k, v in read_counts().items()}
    scores = net.decrypt(res)
    out["ml_fhe_counts"] = read_counts()
    clear = net.clear_forward(X)
    n_pbs = ML_BATCH * head.w.shape[0]
    acc = float((np.argmax(scores, axis=1) == y).mean())
    check(scores.shape == (ML_BATCH, 3) and np.array_equal(scores, clear),
          "ml_fhe: the decrypted scores equal clear_forward")
    check(acc >= 0.9, f"ml_fhe: accuracy {acc} >= 0.9")
    check(run_counts == {"K1": 0, "K2": 0, "K3": 1, "K4": 0},
          f"ml_fhe: one K3 launch for the {n_pbs} PBS of the TLU layer, no K1/K2/K4 ({run_counts})")

    def layer_ms():
        """ms of each layer of one run (the card synchronised after each)."""
        ms = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in net.run_layers(enc):
            torch.cuda.synchronize()
            now = time.perf_counter()
            ms.append((now - t) * 1e3)
            t = now
        return ms

    layer_ms()  # warm-up
    ms = layer_ms()
    print(f"ml_fhe: {P.name}, conv2d_as_linear 25 -> 27, FheTlu, FheLinear 27 -> 3, batch {ML_BATCH}: "
          f"keygen_s {keygen_s:.3f}; {sum(ms):.3f} ms per run (FheLinear conv {ms[0]:.3f} ms, TLU layer "
          f"{ms[1]:.3f} ms = {n_pbs} PBS in one K3 launch, {n_pbs / ms[1] * 1e3:.1f} PBS/s, FheLinear head "
          f"{ms[2]:.3f} ms); scores equal clear_forward, accuracy {acc:.3f}; launches per run {run_counts}",
          flush=True)
    out["ml_fhe"] = dict(keygen_s=keygen_s, run_ms=sum(ms), layer_ms=ms, pbs=n_pbs, accuracy=acc)

    # K3 at the TLU layer's shape, outside the counting window: the layer's
    # accumulators and exponents rebuilt from the conv layer's output as
    # apply_lut builds them, one launch over all n_pbs, whose extracted
    # output must be the layer's; the plain steps on 64 of them, the first
    # 16, 32 across index 512 and the last 16
    tlu, n = layers[1], P.polynomial_size
    (_, conv_ct), (_, tlu_ct) = list(net.run_layers(enc))[:2]
    if tlu.offset:
        conv_ct = lwe_add_plain(conv_ct, _u64.const(tlu.offset * P.delta))
    ms_ = mod_switch(keyswitch(conv_ct.reshape(n_pbs, -1), net.sk.ksk), int(math.log2(2 * n)))
    acc0 = negacyclic_monomial_rotate(net._luts[0], (2 * n - ms_[..., -1])[..., None]).contiguous()
    e_all = ms_[..., :-1].t().to(torch.int32).contiguous()
    bsk = net.sk.bsk
    key = (bsk.bsk_ntt, bsk.rot_table, engine_for(P, dev), bsk.gadget.base_log, bsk.shift)
    k3_out = brc.cmux_steps(acc0, e_all, *key)
    check(torch.equal(sample_extract(k3_out, 0), tlu_ct.reshape(n_pbs, -1)),
          f"ml_fhe: K3 on the rebuilt {n_pbs} accumulators gives the TLU layer's ciphertexts")
    pick = torch.cat([torch.arange(16), torch.arange(496, 528), torch.arange(n_pbs - 16, n_pbs)]).to(dev)
    k3_plain = brc.cmux_steps_plain(acc0[pick].contiguous(), e_all[:, pick].contiguous(), *key)
    k3_err = int((k3_out[pick] - k3_plain).abs().max())
    check(k3_err == 0, f"ml_fhe: K3 at {n_pbs} ct vs plain on 64 of them, past index 512 (err {k3_err})")
    k3_ms = cuda_ms(lambda: brc.cmux_steps(acc0, e_all, *key), 3)
    print(f"ml_fhe: K3 at the TLU layer's {n_pbs} ct x {P.lwe_dimension} steps: {k3_ms:.4f} ms; extracted output "
          f"equals the layer's; vs plain on ct 0-15, 496-527, {n_pbs - 16}-{n_pbs - 1}: err {k3_err}", flush=True)
    out["k3"] = dict(err=k3_err, ms=k3_ms, batch=n_pbs)
    del net, enc, res, acc0, e_all, k3_out, key

    # -- ml_qm ------------------------------------------------------------------
    model = mnist_mlp()
    host = np.random.default_rng(SEED + 22)
    cal = host.random((256, 784))
    x = host.random((ML_BATCH, 784))
    qm = compile_torch_model(model, cal, n_bits=6)
    reset_counts()
    t0 = time.perf_counter()
    qm.compile(seed=SEED + 23, device=dev)
    torch.cuda.synchronize()
    qm_keygen_s = time.perf_counter() - t0
    # a warm-up forward first: the first matmul at N = 2048 in a process
    # also builds the engine's body-extraction row (one more K2, once)
    qm.forward(x, fhe="execute")
    before = read_counts()
    y_exec = qm.forward(x, fhe="execute")
    fwd_counts = {k: v - before[k] for k, v in read_counts().items()}
    out["ml_qm_counts"] = read_counts()
    n_gemm = sum(isinstance(op, QuantizedGemm) for op in qm.ops)
    check(fwd_counts == {"K1": 7 * n_gemm, "K2": 4 * n_gemm, "K3": 0, "K4": 0},
          f"ml_qm: the EXECUTE forward launches 7 K1 and 4 K2 per Gemm, no K3/K4 ({fwd_counts})")
    # every K1/K2 call of a second forward, outside the counting window,
    # against its plain version on the same input
    ntt_calls = ntt_calls_vs_plain(lambda: qm.forward(x, fhe="execute"))
    calls = {k: sum(c for name, (_, c) in ntt_calls.items() if name.startswith(k)) for k in ("K1", "K2")}
    check(calls == {"K1": fwd_counts["K1"], "K2": fwd_counts["K2"]} and all(e == 0 for e, _ in ntt_calls.values()),
          f"ml_qm: every K1/K2 call of a forward equal to its plain version ({ntt_calls})")
    print("ml_qm: K1/K2 vs plain at every call of a forward (error, calls): "
          + "; ".join(f"{name} {e} x{c}" for name, (e, c) in ntt_calls.items()), flush=True)
    out["ntt_err"] = {k: max(e for name, (e, _) in ntt_calls.items() if name.startswith(k)) for k in ("K1", "K2")}
    y_clear = qm.forward(x, fhe="disable")
    check(np.isfinite(y_exec).all() and y_exec.shape == (ML_BATCH, 10), "ml_qm: finite (batch, 10) output")
    agree = float((np.argmax(y_exec, axis=1) == np.argmax(y_clear, axis=1)).mean())
    qm_ms = host_ms(lambda: qm.forward(x, fhe="execute"))
    # each Gemm against its own DISABLE output on the same (EXECUTE-chain) input
    lsbs = []
    h = qm.dequantize_input(qm.quantize_input(x))
    for op in qm.ops:
        nxt = op.forward(h, FheMode.EXECUTE)
        if isinstance(op, QuantizedGemm):
            ref = op.forward(h, FheMode.DISABLE)
            lsb = float(op._exec.last_input_quantizer.scale) * float(op._exec.w_quant.scale)
            lsbs.append(float(np.abs(nxt - ref).max() / lsb))
        h = nxt
    check(max(lsbs) <= 256, f"ml_qm: every Gemm's EXECUTE within 256 accumulator LSBs of DISABLE ({lsbs})")
    print(f"ml_qm: compile_torch_model 784 -> 128 -> 128 -> 10 (ReLU, n_bits 6), {n_gemm} Gemms at "
          f"{qm.ops[0]._exec.params.name}, batch {ML_BATCH}: keygen_s {qm_keygen_s:.3f}; {qm_ms:.3f} ms per "
          f"EXECUTE forward (warm); argmax agreement with DISABLE {agree:.3f}; max |EXECUTE - DISABLE| per Gemm "
          + ", ".join(f"{v:.3f}" for v in lsbs) + f" accumulator LSBs (budget 256); launches per forward "
          f"{fwd_counts}", flush=True)
    out["ml_qm"] = dict(keygen_s=qm_keygen_s, forward_ms=qm_ms, agreement=agree, lsbs=lsbs, launches=fwd_counts)
    return out


class Frame:
    """The members of a pandas DataFrame that DataFrameClient.encrypt_from_pandas
    reads (`columns`, `len()`, `frame[name]`): the card machine has no pandas."""

    def __init__(self, data: dict):
        self.data = data
        self.columns = list(data)

    def __len__(self):
        return len(next(iter(self.data.values())))

    def __getitem__(self, name):
        return self.data[name]


def record_forward(obj, store: dict, key):
    """Wrap obj.forward so that each call leaves (input as float64, output) in
    store[key]."""
    import numpy as np

    fwd = obj.forward

    def run(a, *args, **kw):
        res = fwd(a, *args, **kw)
        store[key] = (np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1]), res)
        return res

    obj.forward = run


def lsbs_off(x, y, w_q, w_quant, n_bits_in: int, bias) -> float:
    """Largest |y - the clear quantized product on x| in accumulator LSBs,
    the input quantized as GlweLinearLayerExecutor and FHEModelClient do."""
    import numpy as np

    from tfhe_tpu_torch.ml.quantization import UniformQuantizer

    xq = UniformQuantizer(n_bits_in, is_signed=False).fit(x)
    acc = xq.quant(x).astype(np.float64) @ w_q.astype(np.float64)
    w_scale = np.asarray(w_quant.scale, np.float64)
    clear = (acc - float(xq.zero_point) * w_q.sum(axis=0)) * float(xq.scale) * w_scale
    if bias is not None:
        clear = clear + np.asarray(bias, np.float64)
    return float(np.abs(np.asarray(y, np.float64).reshape(clear.shape) - clear).max() / (float(xq.scale) * float(w_scale)))


def ml_deploy_phase(dev, reset_counts, read_counts, mm_params, df_params) -> dict:
    """The ML deployment side, the launch counts reset before each path and
    read after it, timed with the port's Timings (synchronised on the card):

    hybrid: serve_hybrid_model of the MNIST MLP's layers 0 and 2 at
    `mm_params` into a HybridFHEModelServer on the card, served by
    HybridHTTPServer on 127.0.0.1:0; a RemoteHybridModel client over
    HTTPTransport (layer 4 copied from the provider) runs a warm-up forward,
    then one on ML_BATCH rows: finite (ML_BATCH, 10) on the input's device
    and dtype, within rel 0.25 of the provider's float forward, each remote
    layer within 256 accumulator LSBs of the clear product on the same
    quantized input, exactly 7 K1 and 4 K2 per remote layer and no K3/K4;
    every K1/K2 call of a remote forward equal to its plain version; one
    /compute under device_trace, whose Chrome trace names k1_forward. The
    hybrid path's counts are read right after the counted forward, before
    those replays. Then an in-process HybridFHEModel with keys on the card,
    a path of its own (counts reset before its compile): each layer's
    EXECUTE within 256 LSBs of its DISABLE, K1 and K2 launched, no K3/K4.

    lora: LoraTraining of the same MLP (layers 0 and 2, rank 4) compiled on
    the card, LoraTrainer.train on 2 batches of ML_BATCH rows in EXECUTE:
    finite losses, lora_b moved off zero in both layers, 7 K1 and 4 K2 per
    base layer per step, each base layer's EXECUTE within 256 LSBs of DISABLE.

    pandas: a DataFrameClient at `df_params` (value_bits 8) on the card, a
    left merge of MERGE_ROWS x MERGE_ROWS rows with unique keys, half of the
    left keys matching: every decrypted value equal to numpy's left merge (0
    where no key matches), K4 launched and K3 not, save -> load round-trips;
    K4's output at the merge's first call of each batch size, recorded during
    the merge, against its plain version on the same inputs."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tfhe_tpu_torch.ml.hybrid import HybridFHEModel, RemoteHybridModel, serve_hybrid_model
    from tfhe_tpu_torch.ml.hybrid_server import HTTPTransport, HybridFHEModelServer, HybridHTTPServer
    from tfhe_tpu_torch.ml.lora import LoraTrainer, LoraTraining
    from tfhe_tpu_torch.ml.pandas import DataFrameClient, EncryptedDataFrame
    from tfhe_tpu_torch.models import integer as ri
    from tfhe_tpu_torch.ops import multibit_cuda as mbc
    from tfhe_tpu_torch.utils import serialization
    from tfhe_tpu_torch.utils.profiling import Timings, device_trace

    def sync():
        torch.cuda.synchronize(dev)

    def delta(before):
        return {k: v - before[k] for k, v in read_counts().items()}

    class TimedTransport(HTTPTransport):
        """HTTPTransport timing each route into `self.tm` and keeping the
        evaluation-key blob sizes."""

        def __init__(self, base_url):
            super().__init__(base_url)
            self.tm, self.key_bytes = Timings(), []

        def get_client(self, model_name, module_name):
            with self.tm.section("/get_client"):
                return super().get_client(model_name, module_name)

        def add_key(self, key, model_name, module_name):
            self.key_bytes.append(len(key))
            with self.tm.section("/add_key"):
                return super().add_key(key, model_name, module_name)

        def compute(self, model_input, uid, model_name, module_name):
            with self.tm.section(f"/compute {module_name}"):
                return super().compute(model_input, uid, model_name, module_name)

    out, paths, tm = {}, {}, Timings()
    names = ["0", "2"]  # the remote (private) layers; layer 4 stays local
    net = mnist_mlp()
    host = np.random.default_rng(SEED + 30)
    x = torch.from_numpy(host.random((ML_BATCH, 784)).astype(np.float32))
    want = net(x).detach().numpy()
    xd = x.to(dev)
    tmp_dirs = []

    # -- hybrid -----------------------------------------------------------------
    reset_counts()
    core = HybridFHEModelServer(device=dev)
    serve_hybrid_model(net, names, "mnist", core, params=mm_params)
    httpd = HybridHTTPServer(core).start()
    try:
        transport = TimedTransport(f"http://127.0.0.1:{httpd.port}")
        # the client's own net: the provider ships layer 4; layers 0 and 2
        # are swapped out, their weights never leave the server
        client_net = mnist_mlp(SEED + 35)
        client_net[4].load_state_dict(net[4].state_dict())
        with tm.section("client setup", sync=sync):
            remote = RemoteHybridModel(client_net.to(dev), names, "mnist", transport, key_seed=SEED + 31, device=dev)
        setup = transport.tm.report()
        remote(xd)  # warm-up
        seen = {}
        for nm in names:
            record_forward(remote.remotes[nm], seen, nm)
        transport.tm = Timings()
        before = read_counts()
        with tm.section("hybrid forward", sync=sync):
            y = remote(xd)
        fwd_counts = delta(before)
        paths["hybrid"] = read_counts()  # the checks and replays below run outside the window
        routes = transport.tm.report()
        got = y.detach().cpu().numpy()
        check(y.device == xd.device and y.dtype == xd.dtype and got.shape == (ML_BATCH, 10) and np.isfinite(got).all(),
              "hybrid: a finite (batch, 10) output on the input's device and dtype")
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        check(rel < 0.25, f"hybrid: the remote forward within rel 0.25 of the provider's float forward ({rel:.4f})")
        lsbs = []
        for nm in names:
            cl = remote.remotes[nm].client
            lsbs.append(lsbs_off(*seen[nm], cl.w_q, cl.w_quant, cl.meta["n_bits_in"], cl.bias))
        check(max(lsbs) <= 256, f"hybrid: each remote layer within 256 accumulator LSBs of the clear product ({lsbs})")
        check(fwd_counts == {"K1": 7 * len(names), "K2": 4 * len(names), "K3": 0, "K4": 0},
              f"hybrid: 7 K1 and 4 K2 per remote layer per forward, no K3/K4 ({fwd_counts})")
        # every K1/K2 call of another remote forward against its plain version
        ntt_calls = ntt_calls_vs_plain(lambda: remote(xd))
        calls = {k: sum(c for name, (_, c) in ntt_calls.items() if name.startswith(k)) for k in ("K1", "K2")}
        check(calls == {"K1": fwd_counts["K1"], "K2": fwd_counts["K2"]} and all(e == 0 for e, _ in ntt_calls.values()),
              f"hybrid: every K1/K2 call of a remote forward equal to its plain version ({ntt_calls})")
        out["ntt_err"] = {k: max(e for name, (e, _) in ntt_calls.items() if name.startswith(k)) for k in ("K1", "K2")}
        # the server deserializes the evaluation key on every run
        evk = core.keys[remote.remotes["0"].uid]
        for _ in range(3):
            with tm.section("evk deserialize", sync=sync):
                serialization.deserialize(evk, device=dev)
        # one /compute under the device trace
        r0 = remote.remotes["0"]
        blob, _ = r0.client.quantize_encrypt_serialize(seen["0"][0])
        trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
        tmp_dirs.append(trace_dir)
        with device_trace(trace_dir) as trace_path:
            transport.compute(blob, r0.uid, "mnist", "0")
        with open(trace_path) as f:
            trace = f.read()
        check("k1_forward" in trace, "hybrid: the device trace of one /compute names the K1 kernel")
        tmp_dirs += [e["path"] for e in core.modules["mnist"].values()] + [r._dir for r in remote.remotes.values()]
    finally:
        httpd.stop()
    rep = tm.report()
    out["hybrid"] = dict(forward_ms=rep["hybrid forward"]["mean_ms"], routes=routes, setup=setup,
                         key_bytes=transport.key_bytes, evk_deserialize_ms=rep["evk deserialize"]["mean_ms"],
                         rel=rel, lsbs=lsbs, launches=fwd_counts, trace_bytes=len(trace))
    print(f"hybrid: serve_hybrid_model 784 -> 128 -> 128 -> 10, layers {', '.join(names)} remote at {mm_params.name}, "
          f"RemoteHybridModel over HTTPTransport, batch {ML_BATCH}: {rep['hybrid forward']['mean_ms']:.3f} ms per "
          "forward (" + ", ".join(f"{k} {v['mean_ms']:.3f} ms" for k, v in routes.items()) + f"); client setup "
          f"{rep['client setup']['mean_ms']:.3f} ms (/get_client {setup['/get_client']['mean_ms']:.3f} ms, /add_key "
          f"{setup['/add_key']['mean_ms']:.3f} ms for {transport.key_bytes[0]} key bytes, x{setup['/add_key']['count']}); "
          f"evaluation key deserialize {rep['evk deserialize']['mean_ms']:.3f} ms per run; rel err vs float "
          f"{rel:.4f} (budget 0.25); max |remote - clear| per layer " + ", ".join(f"{v:.3f}" for v in lsbs)
          + f" accumulator LSBs (budget 256); launches per forward {fwd_counts}", flush=True)
    print("hybrid: K1/K2 vs plain at every call of a remote forward (error, calls): "
          + "; ".join(f"{name} {e} x{c}" for name, (e, c) in ntt_calls.items()), flush=True)
    # in process: HybridFHEModel on the same net, keys on the card, its own path
    reset_counts()
    hyb = HybridFHEModel(copy.deepcopy(net), names, params=mm_params).compile(seed=SEED + 32, device=dev)
    hyb.model.to(dev)  # the local layer 4
    hseen = {}
    for nm, layer in hyb._fhe_layers.items():
        record_forward(layer.executor, hseen, nm)
    y_hyb = hyb(xd, fhe="execute")
    paths["hybrid_in_process"] = read_counts()
    check(y_hyb.device == xd.device and bool(torch.isfinite(y_hyb).all()), "hybrid: in-process EXECUTE output finite")
    hyb_lsbs = []
    for nm, layer in hyb._fhe_layers.items():
        ex = layer.executor
        hyb_lsbs.append(lsbs_off(hseen[nm][0], hseen[nm][1], ex.w_q, ex.w_quant, ex.n_bits_in, ex.bias))
    check(max(hyb_lsbs) <= 256, f"hybrid: in-process EXECUTE within 256 LSBs of DISABLE per layer ({hyb_lsbs})")
    hyb_counts = paths["hybrid_in_process"]
    check(hyb_counts["K1"] > 0 and hyb_counts["K2"] > 0 and hyb_counts["K3"] == 0 and hyb_counts["K4"] == 0,
          f"hybrid: the in-process compile and EXECUTE launch K1 and K2, no K3/K4 ({hyb_counts})")
    out["hybrid"]["hyb_lsbs"] = hyb_lsbs
    print(f"hybrid: in-process HybridFHEModel EXECUTE vs DISABLE per layer " + ", ".join(f"{v:.3f}" for v in hyb_lsbs)
          + f" accumulator LSBs (budget 256); launches (compile and one forward) {hyb_counts}; device_trace of one "
          f"/compute {len(trace)} bytes, names k1_forward", flush=True)
    del remote, core, hyb, evk

    # -- lora -------------------------------------------------------------------
    reset_counts()
    lt = LoraTraining(copy.deepcopy(net), rank=4, target_modules=names, params=mm_params)
    lt.model.to(dev)
    lt.compile(seed=SEED + 33, device=dev)
    trainer = LoraTrainer(lt)
    g = np.random.default_rng(SEED + 34)
    data = [(torch.from_numpy(g.random((ML_BATCH, 784)).astype(np.float32)).to(dev),
             torch.from_numpy(g.random((ML_BATCH, 10)).astype(np.float32)).to(dev)) for _ in range(2)]
    lseen = {}
    for nm, layer in lt._lora_layers.items():
        record_forward(layer.executor, lseen, nm)
    before = read_counts()
    with tm.section("lora train", sync=sync):
        losses = trainer.train(data, epochs=1, fhe="execute")
    train_counts = delta(before)
    paths["lora"] = read_counts()
    step_counts = {k: v / len(data) for k, v in train_counts.items()}
    check(all(math.isfinite(v) for v in losses), f"lora: finite losses ({losses})")
    moved = [float(layer.lora_b.weight.detach().abs().max()) for layer in lt._lora_layers.values()]
    check(all(m > 0 for m in moved), f"lora: lora_b moved off zero in both layers ({moved})")
    check(step_counts == {"K1": 7 * len(names), "K2": 4 * len(names), "K3": 0, "K4": 0},
          f"lora: 7 K1 and 4 K2 per base layer per step, no K3/K4 ({step_counts})")
    lora_lsbs = []
    for nm, layer in lt._lora_layers.items():
        ex = layer.executor
        lora_lsbs.append(lsbs_off(lseen[nm][0], lseen[nm][1], ex.w_q, ex.w_quant, ex.n_bits_in, ex.bias))
    check(max(lora_lsbs) <= 256, f"lora: each base layer's EXECUTE within 256 LSBs of DISABLE ({lora_lsbs})")
    step_ms = tm.report()["lora train"]["mean_ms"] / len(data)
    out["lora"] = dict(step_ms=step_ms, losses=losses, lsbs=lora_lsbs, launches_per_step=step_counts)
    print(f"lora: LoraTraining 784 -> 128 -> 128 -> 10, layers {', '.join(names)} (rank 4) on FHE at "
          f"{mm_params.name}, LoraTrainer.train on {len(data)} batches of {ML_BATCH} (EXECUTE): {step_ms:.3f} ms per "
          f"step; losses {losses}; max |lora_b| {moved}; base EXECUTE vs DISABLE " + ", ".join(f"{v:.3f}" for v in lora_lsbs)
          + f" accumulator LSBs (budget 256); launches per step {step_counts}", flush=True)
    del lt, trainer, data

    # -- pandas -----------------------------------------------------------------
    reset_counts()
    with tm.section("dataframe keygen", sync=sync):
        client = DataFrameClient(params=df_params, seed=SEED + 40, value_bits=8, device=dev)
    hp = np.random.default_rng(SEED + 41)
    half = MERGE_ROWS // 2
    keys = hp.choice(np.arange(1, 256), MERGE_ROWS + half, replace=False)
    lk, rk = keys[:MERGE_ROWS], hp.permutation(keys[half:])  # left keys [half:] match
    left = Frame({"k": lk, "a": hp.integers(1, 256, MERGE_ROWS)})
    right = Frame({"k": rk, "b": hp.integers(1, 256, MERGE_ROWS)})
    el, er = client.encrypt_from_pandas(left), client.encrypt_from_pandas(right)
    # the merge's K4 calls pass through a recorder that keeps the inputs and
    # output of the first call at each batch size (the kernel still counts
    # its own launches), for the check against plain after the window
    k4_calls, k4_seen = {}, [0]

    def k4_steps(acc, a, *args):
        res = mbc.group_steps(acc, a, *args)
        k4_seen[0] += 1
        if acc.shape[0] not in k4_calls:
            k4_calls[acc.shape[0]] = (acc, a, args, res.clone())
        return res

    pbs = ri.multibit_programmable_bootstrap
    ri.multibit_programmable_bootstrap = lambda ct, lut, bsk, engine: pbs(ct, lut, bsk, engine, k4_steps)
    ri._pbs.rows = 0
    try:
        before = read_counts()
        with tm.section("merge", sync=sync):
            merged = el.merge(er, on="k")
        merge_counts = delta(before)
    finally:
        ri.multibit_programmable_bootstrap = pbs
    n_pbs = ri._pbs.rows
    paths["pandas"] = read_counts()
    match = dict(zip(rk.tolist(), right["b"].tolist()))
    want_cols = {"k": lk, "a": left["a"], "b": np.array([match.get(k, 0) for k in lk.tolist()])}
    got_cols = {name: ri.decrypt_radix(client.ck, c).cpu().numpy() for name, c in merged.columns.items()}
    check(list(got_cols) == ["k", "a", "b"] and all(np.array_equal(got_cols[c], want_cols[c]) for c in want_cols),
          "pandas: the merged columns equal numpy's left merge (0 where no key matches)")
    check(merge_counts["K4"] > 0 and merge_counts["K3"] == 0, f"pandas: K4 launched and K3 not ({merge_counts})")
    save_dir = tempfile.mkdtemp(prefix="chip_smoke_edf_")
    tmp_dirs.append(save_dir)
    merged.save(f"{save_dir}/merged.edf")
    back = EncryptedDataFrame.load(f"{save_dir}/merged.edf", client.sk)
    check(all(torch.equal(back.columns[c].blocks, merged.columns[c].blocks) and back.columns[c].blocks.device.type == dev.type
              for c in merged.columns), "pandas: save -> load round-trips on the card")
    merge_ms = tm.report()["merge"]["mean_ms"]
    # K4's own output at the first merge call of each batch size against its
    # plain version on the same inputs, on its first and last 4 ciphertexts
    check(k4_seen[0] == merge_counts["K4"], f"pandas: every K4 launch of the merge went through the recorder "
                                            f"({k4_seen[0]} of {merge_counts['K4']})")
    k4_errs = {}
    for nb, (acc, a, args, res) in sorted(k4_calls.items()):
        pick = torch.unique(torch.cat([torch.arange(min(4, nb)), torch.arange(max(nb - 4, 0), nb)])).to(dev)
        plain = mbc.group_steps_plain(acc[pick].contiguous(), a[:, pick].contiguous(), *args)
        k4_errs[nb] = int((res[pick] - plain).abs().max())
    del k4_calls
    out["k4_err"] = max(k4_errs.values())
    check(out["k4_err"] == 0, f"pandas: K4 at the merge's first call of each batch size vs plain ({k4_errs})")
    p = df_params
    out["pandas"] = dict(merge_ms=merge_ms, pbs=n_pbs, launches=merge_counts, rows=MERGE_ROWS, k4_errs=k4_errs,
                         matches=half, keygen_ms=tm.report()["dataframe keygen"]["mean_ms"])
    print(f"pandas: DataFrameClient at {p.name}, value_bits 8, left merge of {MERGE_ROWS} x {MERGE_ROWS} rows "
          f"({half} keys matching): {merge_ms:.3f} ms per merge, {n_pbs} PBS (counted), launches {merge_counts}; "
          f"keygen {out['pandas']['keygen_ms']:.3f} ms; decrypted columns equal numpy's merge; save -> load "
          f"round-trips; K4 at the merge's first call of each batch size vs plain on up to 8 of its ciphertexts "
          f"(batch: err) {k4_errs}", flush=True)
    for d in tmp_dirs:
        shutil.rmtree(d, ignore_errors=True)
    out["paths"] = paths
    return out


def random_inputs(eng, seed: int):
    """Random kernel inputs on the engine's device from a seeded generator,
    and the two error measures: rand_i32(shape, lo, hi), rand_u64(shape),
    rand_key_rows(lead) (Shoup key rows of the engine's primes at its N),
    mod_err (max difference mod each prime: K1's lazy residues) and
    exact_err."""
    import torch

    dev, n, n_pr = eng.device, eng.n, eng.n_primes
    primes = torch.tensor(eng.primes, device=dev).view(1, n_pr, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

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

    return rand_i32, rand_u64, rand_key_rows, mod_err, exact_err


def rng_phase(dev) -> None:
    """The port's FheRng (JAX's threefry2x32) draws on the card what it
    draws on the CPU from the same seed: uniform_torus, binary and
    tuniform(b) for b = 17 and 61, RNG_VALUES values each, after a split
    and a fork; then the card's time per uniform_torus draw."""
    import torch

    from tfhe_tpu_torch.rng import FheRng

    t0 = time.perf_counter()
    card, host = FheRng(SEED, dev).split(3)[2].fork(), FheRng(SEED, "cpu").split(3)[2].fork()
    draws = {
        "uniform_torus": lambda r: r.uniform_torus((RNG_VALUES,)),
        "binary": lambda r: r.binary((RNG_VALUES,)),
        "tuniform17": lambda r: r.tuniform(17, (RNG_VALUES,)),
        "tuniform61": lambda r: r.tuniform(61, (RNG_VALUES,)),
    }
    diff = {}
    for name, draw in draws.items():
        a, b = draw(card), draw(host)
        check(a.is_cuda and a.shape == b.shape, f"rng: {name} drawn on the card")
        diff[name] = int((a.cpu() != b).sum())
    check(all(v == 0 for v in diff.values()), f"rng: the card's draws equal the CPU's ({diff} values differ)")
    ms = cuda_ms(lambda: FheRng(SEED, dev).uniform_torus((RNG_VALUES,)), 5)
    print(f"rng: FheRng({SEED}) split/fork, {RNG_VALUES} values each of uniform_torus, binary, tuniform(17), "
          f"tuniform(61): card == CPU, differing {diff}; uniform_torus of {RNG_VALUES} on the card "
          f"{ms:.4f} ms; phase {time.perf_counter() - t0:.1f} s", flush=True)


def run_child(flag: str, env: dict | None = None) -> dict:
    """Run this script with `flag` in a child process, echo its lines and
    return the result on its last line (one JSON object keyed by the flag's
    name). The child reuses the kernels built here."""
    key = flag.lstrip("-").replace("-", "_")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag],
        env=dict(os.environ, **(env or {})), capture_output=True, text=True, timeout=900,
    )
    lines = proc.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the {flag} child failed (exit {proc.returncode}): {proc.stderr[-6000:]}")
    res = json.loads(lines[-1])[key]
    res["wall_s"] = time.perf_counter() - t0
    print(f"{key}: child process {res['wall_s']:.1f} s", flush=True)
    return res


def four_prime_main() -> int:
    """The 4-prime path (run by main() in a child process under
    TFHE_TPU_PRIMES=4, the JAX package's process-level switch, read once at
    import; shortint.keygen takes no prime set): K1-K4 launched at P = 4
    and held against their plain versions bit for bit (K1 mod p); then,
    counts reset before each, the 2_2 keygen (K1, K2) with apply_lut on
    BATCH ciphertexts (K3), and the GROUP_3 keygen with apply_lut on BATCH
    (K4), decrypted. K3 and K4 run at the paths' full shape; their plain
    versions, host-bound at ~40 s for 512 ciphertexts, on the first
    P4_PLAIN_CT of them. The last line is one JSON object that main() reads."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --four-prime: no CUDA device", file=sys.stderr)
        return 2

    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.core.lwe import keyswitch
    from tfhe_tpu_torch.core import multibit as mb
    from tfhe_tpu_torch.models import shortint as si
    from tfhe_tpu_torch.ops import blind_rotate_cuda as brc
    from tfhe_tpu_torch.ops import multibit_cuda as mbc
    from tfhe_tpu_torch.ops import ntt_cuda
    from tfhe_tpu_torch.ops.folded_ntt import FOLDED_PRIMES, FOLDED_PRIMES_4, default_primes, get_folded_engine
    from tfhe_tpu_torch.rng import FheRng
    from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate

    check(default_primes() == FOLDED_PRIMES_4, f"TFHE_TPU_PRIMES=4 selects FOLDED_PRIMES_4, got {default_primes()}")
    PARAMS = tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    MB3 = tp.PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    dev = torch.device("cuda")
    build_s = _build.build_all()
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
    check(n_pr == 4 and eng.max_product_bits == 83, f"P = 4 engine at N = {n} ({n_pr} primes, {eng.max_product_bits} bits)")
    rand_i32, rand_u64, rand_key_rows, mod_err, exact_err = random_inputs(eng, SEED + 4)
    err = {k: [] for k in wrappers}
    clusters = {"K3": brc.max_active_clusters(eng), "K4 g=3": mbc.max_active_clusters(eng, 3)}
    eng3 = get_folded_engine(n, dev, primes=FOLDED_PRIMES)
    clusters_p3 = {"K3": brc.max_active_clusters(eng3), "K4 g=3": mbc.max_active_clusters(eng3, 3)}
    print(f"four_prime: primes {eng.primes} (CRT range 2^{math.log2(math.prod(eng.primes)):.2f}, max_product_bits "
          f"{eng.max_product_bits}); build_s {build_s:.3f} (reused); clusters of {n_pr} resident at once {clusters} "
          f"(of 3 at P = 3: {clusters_p3})", flush=True)

    # -- K1 and K2 at P = 4 ------------------------------------------------------
    x3 = rand_i32((BATCH, n), -(2**23), 2**23 + 1)
    x4 = rand_i32((BATCH, n), -(2**31) + 1, 2**31)
    f4 = ntt_cuda.forward(eng, x4, small=True)
    err["K1"] += [mod_err(eng.forward_small(x3), eng.forward_small_plain(x3)), mod_err(f4, eng.forward_i32_plain(x4))]
    err["K2"].append(exact_err(ntt_cuda.inverse(eng, f4), eng.inverse_plain(f4)))
    polys = rand_i32((2 * n, n), -1, 2)  # keygen's largest K1 call: a monomial table
    err["K1"].append(mod_err(eng.forward_small(polys), eng.forward_small_plain(polys)))
    k1 = dict(**kernel_ms(lambda: eng.forward_small(polys), 10, "k1_forward"),
              plain_ms=cuda_ms(lambda: eng.forward_small_plain(polys), 2), shape=f"({2 * n}, {n}) int32 -> ({2 * n}, {n_pr}, {n})")
    k1["bound_ms"], k1["bound_by"] = k1_bound(2 * n, n_pr, n, 4)
    u = rand_u64((4 * PARAMS.lwe_dimension, n))
    err["K1"].append(mod_err(eng.forward_u64(u), eng.forward_u64_plain(u)))
    rows2 = 2 * PARAMS.lwe_dimension  # keygen's K2 call: the BSK's GLWE encryption
    f2 = eng.forward_u64(rand_u64((rows2, n)))
    err["K2"].append(exact_err(ntt_cuda.inverse(eng, f2), eng.inverse_plain(f2)))
    k2 = dict(**kernel_ms(lambda: ntt_cuda.inverse(eng, f2), 10, "k2_inverse"),
              plain_ms=cuda_ms(lambda: eng.inverse_plain(f2), 2), shape=f"({rows2}, {n_pr}, {n})")
    k2["bound_ms"], k2["bound_by"] = k2_bound(rows2, n_pr, n)
    i32_ext = torch.tensor([2**31 - 1, -(2**31) + 1, -(2**31), -1, 0, 1], device=dev, dtype=torch.int32)
    u64_ext = torch.tensor([0, -1, 1, 2**32 - 1, 2**32, -(2**63)], device=dev, dtype=torch.int64)
    for rows in (1, 3, 1537):
        xi = rand_i32((rows, n), -(2**31), 2**31)
        xi[0, :6] = i32_ext
        xu = rand_u64((rows, n))
        xu[0, :6] = u64_ext
        fi = ntt_cuda.forward(eng, xi, small=True)
        err["K1"] += [mod_err(fi, eng.forward_i32_plain(xi)),
                      mod_err(ntt_cuda.forward(eng, xu, small=False), eng.forward_u64_plain(xu))]
        err["K2"].append(exact_err(ntt_cuda.inverse(eng, fi), eng.inverse_plain(fi)))
    check(not any(err["K1"] + err["K2"]), f"K1/K2 at P = 4 vs plain (err K1 {err['K1']}, K2 {err['K2']})")
    print(f"four_prime: check K1 (512, {n}) nb=3/nb=4, ({2 * n}, {n}), u64 ({4 * PARAMS.lwe_dimension}, {n}), ragged "
          f"1/3/1537 rows with extreme inputs: err {err['K1']}; K2 err {err['K2']}; K1 {k1['ms']:.4f} ms at "
          f"({2 * n}, {n}) (plain {k1['plain_ms']:.4f}), K2 {k2['ms']:.4f} ms at ({rows2}, {n_pr}, {n}) "
          f"(plain {k2['plain_ms']:.4f})", flush=True)
    del x3, x4, f4, polys, u, f2

    # -- K3 and K4 at P = 4: 4 steps / groups at ragged batches ----------------
    base_log = PARAMS.pbs.base_log
    acc = rand_u64((64, 2, n))
    rot_table = brc.monomial_ntt_table(eng)
    bsk = rand_key_rows((4, 2, 2))
    for nb in (1, 3, 64):
        exps = rand_i32((4, nb), 0, 2 * n)
        exps[0, 0], exps[1, nb // 2], exps[2, nb - 1], exps[3, 0] = 0, n, 2 * n - 1, n + 1
        err["K3"].append(exact_err(brc.cmux_steps(acc[:nb], exps, bsk, rot_table, eng, base_log, 9),
                                   brc.cmux_steps_plain(acc[:nb], exps, bsk, rot_table, eng, base_log, 9)))
    x_table = mb.monomial_x_table(eng)
    for g in mbc.GROUP_SIZES:
        bsk = rand_key_rows((4, 1 << g, 2, 2))
        for nb in (1, 3, 64):
            a = rand_i32((4 * g, nb), 0, 2 * n)
            err["K4"].append(exact_err(mbc.group_steps(acc[:nb], a, bsk, x_table, eng, base_log, 9, g),
                                       mbc.group_steps_plain(acc[:nb], a, bsk, x_table, eng, base_log, 9, g)))
    check(not any(err["K3"] + err["K4"]), f"K3/K4 at P = 4 vs plain at 1/3/64 ct (err K3 {err['K3']}, K4 {err['K4']})")
    print(f"four_prime: check K3 (4 steps) at 1/3/64 ct err {err['K3']}; K4 (4 groups, g = 2/3/4) err {err['K4']}",
          flush=True)
    del acc, bsk, rot_table, x_table

    vals = torch.arange(BATCH, device=dev) % PARAMS.message_modulus
    paths, kern, keys = {}, {}, {}

    def run_path(name, params, rng_seed):
        """keygen, encrypt BATCH values, the identity apply_lut; counted."""
        reset_counts()
        t0 = time.perf_counter()
        ck, sk = si.keygen(params, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        c = si.encrypt(ck, vals, FheRng(rng_seed, "cuda"))
        lut = si.generate_lut(params, lambda v: v, "cuda")
        out = si.apply_lut(sk, c, lut, 3)
        paths[name] = read_counts()
        check(bool((si.decrypt(ck, out) == vals).all()), f"{name}: identity LUT on {BATCH} ct decrypts to the inputs")
        ms = cuda_ms(lambda: si.apply_lut(sk, c, lut, 3), 3)
        keys[name] = dict(msb=64 - sk.bsk.shift, key_bytes=sk.bsk.bsk_ntt.numel() * 4, keygen_s=keygen_s,
                          apply_lut_ms=ms, pbs_per_s=BATCH / ms * 1e3)
        small = keyswitch(c.ct, sk.ksk)
        ms_ = mod_switch(small, int(math.log2(2 * n)))
        acc0 = negacyclic_monomial_rotate(lut, (2 * n - ms_[..., -1])[..., None]).contiguous()
        return sk, acc0, ms_[..., :-1].t().to(torch.int32).contiguous()

    def rotation_entry(key, launch, plain, acc0, e_all, shape, bound):
        """The kernel at the path's full batch, its plain version on the
        first P4_PLAIN_CT ciphertexts, equal there."""
        ms = cuda_ms(lambda: launch(acc0, e_all), 3)
        out = launch(acc0, e_all)
        box = {}
        plain_ms = host_ms(lambda: box.update(out=plain(acc0[:P4_PLAIN_CT].contiguous(), e_all[:, :P4_PLAIN_CT].contiguous())))
        err[key].append(exact_err(out[:P4_PLAIN_CT], box["out"]))
        check(err[key][-1] == 0, f"{key} at P = 4 vs plain on the first {P4_PLAIN_CT} ct of the path (err {err[key][-1]})")
        b, o = bound
        return dict(ms=ms, plain_ms=plain_ms, plain_shape=f"{P4_PLAIN_CT} ct", bound_ms=b, bound_by=o, shape=shape)

    # -- the classic path at P = 4: keygen (K1, K2), apply_lut on BATCH (K3) ------
    sk, acc0, e_all = run_path("classic_p4", PARAMS, SEED + 1)
    steps = PARAMS.lwe_dimension
    k3args = (sk.bsk.bsk_ntt, sk.bsk.rot_table, eng, base_log, sk.bsk.shift)
    kern["K3"] = rotation_entry(
        "K3", lambda a, e: brc.cmux_steps(a, e, *k3args), lambda a, e: brc.cmux_steps_plain(a, e, *k3args),
        acc0, e_all, f"{BATCH} ct x {steps} steps",
        bound_ms(rotation_bytes(BATCH, steps, keys["classic_p4"]["key_bytes"], 1, n_pr, n), cmux_ops(BATCH, steps, n_pr, n)),
    )
    del sk, acc0, e_all, k3args
    # -- the GROUP_3 path at P = 4: keygen, apply_lut on BATCH (K4) -------------
    g3 = si.multibit_group_of(MB3)
    sk, acc0, e_all = run_path("multibit_p4", MB3, SEED + 2)
    groups = sk.bsk.n_groups
    k4args = (sk.bsk.bsk_ntt, sk.bsk.rot_table, eng, base_log, sk.bsk.shift, g3)
    kern["K4"] = rotation_entry(
        "K4", lambda a, e: mbc.group_steps(a, e, *k4args), lambda a, e: mbc.group_steps_plain(a, e, *k4args),
        acc0, e_all, f"{BATCH} ct x {groups} groups (g={g3})",
        bound_ms(rotation_bytes(BATCH, groups, keys["multibit_p4"]["key_bytes"], g3, n_pr, n),
                 group_step_ops(BATCH, groups, g3, n_pr, n)),
    )
    del sk, acc0, e_all, k4args
    check(all(paths["classic_p4"][k] > 0 for k in ("K1", "K2", "K3")) and paths["classic_p4"]["K4"] == 0,
          f"K1-K3 (and not K4) launched on the classic path at P = 4 {paths['classic_p4']}")
    check(paths["multibit_p4"]["K4"] > 0 and paths["multibit_p4"]["K3"] == 0,
          f"K4 (and not K3) launched on the GROUP_3 path at P = 4 {paths['multibit_p4']}")
    check(keys["classic_p4"]["msb"] == 55 and keys["multibit_p4"]["msb"] == 55,
          f"the 4-prime keys keep 55 bits (classic {keys['classic_p4']['msb']}, GROUP_3 {keys['multibit_p4']['msb']})")
    for name, k in keys.items():
        print(f"four_prime: {name}: keygen_s {k['keygen_s']:.3f}, msb {k['msb']}, BSK {k['key_bytes']} bytes; "
              f"apply_lut on {BATCH} {k['apply_lut_ms']:.3f} ms ({k['pbs_per_s']:.1f} PBS/s), decrypt ok; "
              f"launches {paths[name]}", flush=True)

    sources = {"K1": ("ntt_forward_p4", "tfhe_tpu_torch/csrc/ntt.cu", "tfhe_tpu/ops/pallas_ntt.py:494", "classic_p4", k1),
               "K2": ("ntt_inverse_p4", "tfhe_tpu_torch/csrc/ntt.cu", "tfhe_tpu/ops/pallas_ntt.py:518", "classic_p4", k2),
               "K3": ("cmux_steps_p4", "tfhe_tpu_torch/csrc/blind_rotate.cu",
                      "tfhe_tpu/ops/pallas_blind_rotate.py:279", "classic_p4", kern["K3"]),
               "K4": ("group_steps_p4", "tfhe_tpu_torch/csrc/multibit.cu",
                      "tfhe_tpu/ops/pallas_multibit.py:184", "multibit_p4", kern["K4"])}
    entries = {}
    for key, (name, src, repl, path, t) in sources.items():
        entries[key] = dict(name=name, route="cuda", source=src, replaces=repl, launches=paths[path][key],
                            max_abs_err=max(err[key]), equal=max(err[key]) == 0, ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None, path=path,
                            shape=t["shape"], nprimes=n_pr, **({"plain_shape": t["plain_shape"]} if "plain_shape" in t else {}))
        print(f"four_prime: {key} {name} {t['shape']}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms"
              + (f" on {t['plain_shape']}" if "plain_shape" in t else "")
              + f", bound {t['bound_ms']:.4f} by {t['bound_by']}), launches {paths[path][key]}, err {max(err[key])}",
              flush=True)
    print(json.dumps({"four_prime": dict(primes=list(eng.primes), kernels=entries, paths=paths, keys=keys,
                                         clusters=clusters, clusters_p3=clusters_p3)}), flush=True)
    return 0


def coll_summary(stats) -> str:
    """Collectives of one run, from multihost.collective_stats."""
    return "; ".join(
        f"{s['op']} {s['bytes']} B x {s['count']} over ranks {s['replica_groups'][0]}"
        + (" (staged through host memory)" if s["staged"] else "") + (" crossing hosts" if s["crosses_host"] else "")
        for s in stats)


def parallel_main() -> int:
    """The parallel path (run by main() in a child process): the port's
    parallel/ on torch.distributed at PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    batch PAR_BATCH. (a) make_sharded_pbs_step on make_mesh(1, 1), a world
    of one rank under NCCL in this process, counts reset before its first
    run: K1 and K2 once per rotation step; bit-equal to the single-process
    loop of external products (bootstrap.blind_rotate's loop branch,
    driven here) and decrypting as apply_lut (K3) does; K1 and K2 at the
    step's shapes against their plain versions. Then one spawned world of
    PAR_WORLD ranks on the one card under gloo (NCCL refuses two ranks on
    a device), laid out as one rank a host: (b) the step at model width 2,
    bit-equal to (a); (c) make_sharded_ntt at N = 2048 and 4096 equal mod p
    to K1's forward_u64, and its round trip; (d) make_key_sharded_blind_rotate
    bit-equal to (a)'s rotation; (e) make_multihost_pbs_step on 2 hosts x
    model 1 (no collective crosses a host) and the step on the cross-host
    model mesh (its all-reduces cross). The last line is one JSON object."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --parallel: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np
    import torch.distributed as dist

    from tfhe_tpu_torch import _build, _u64
    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.core.ggsw import contract_residues, external_product
    from tfhe_tpu_torch.core.lwe import keyswitch, sample_extract
    from tfhe_tpu_torch.models import shortint as si
    from tfhe_tpu_torch.ops import blind_rotate_cuda as brc
    from tfhe_tpu_torch.ops import multibit_cuda as mbc
    from tfhe_tpu_torch.ops import ntt_cuda
    from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
    from tfhe_tpu_torch.parallel import launch as pl
    from tfhe_tpu_torch.parallel import multihost as mh
    from tfhe_tpu_torch.parallel.mesh import make_mesh
    from tfhe_tpu_torch.parallel.sharded import make_sharded_pbs_step, shard_inputs
    from tfhe_tpu_torch.rng import FheRng
    from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate, signed_decompose

    PARAMS = tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    dev = torch.device("cuda")
    build_s = _build.build_all()
    wrappers = {"K1": ntt_cuda.forward, "K2": ntt_cuda.inverse, "K3": brc.cmux_steps, "K4": mbc.group_steps}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: w.launches for k, w in wrappers.items()}

    n, steps, batch = PARAMS.polynomial_size, PARAMS.lwe_dimension, PAR_BATCH
    eng = get_folded_engine(n, dev)
    n_pr = eng.n_primes
    rand_i32, rand_u64, _, mod_err, exact_err = random_inputs(eng, SEED + 5)
    t0 = time.perf_counter()
    ck, sk = si.keygen(PARAMS, seed=SEED + 20, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    vals = torch.arange(batch, device=dev) % PARAMS.message_modulus
    c = si.encrypt(ck, vals, FheRng(SEED + 21, "cuda"))
    space = PARAMS.message_modulus * PARAMS.carry_modulus
    table = np.asarray([(3 * v + 1) % PARAMS.message_modulus for v in range(space)], dtype=np.uint64)
    lut = si.generate_lut(PARAMS, table, "cuda")
    want = torch.as_tensor(table.astype(np.int64), device=dev)[vals]
    d_rows = (PARAMS.glwe_dimension + 1) * PARAMS.pbs.level
    print(f"parallel ({PARAMS.name}, n={steps}, N={n}, PBS {PARAMS.pbs.level} / {PARAMS.pbs.base_log} so D = {d_rows}, "
          f"KS {PARAMS.ks.level} / {PARAMS.ks.base_log} with n_in = {sk.ksk.n_in}): build_s {build_s:.3f} (reused), "
          f"keygen_s {keygen_s:.3f}, batch {batch}", flush=True)

    # -- (a) world 1 under NCCL, in this process -----------------------------------
    mh.initialize(f"127.0.0.1:{pl.free_port()}", 1, 0, "nccl")
    try:
        mesh = make_mesh(1, 1)
        c_loc, bsk_loc, ksk_loc = shard_inputs(mesh, c.ct, sk.bsk.bsk_ntt, sk.ksk.ksk)
        step = make_sharded_pbs_step(mesh, eng, PARAMS.ks, PARAMS.pbs, bsk_shift=sk.bsk.shift)
        backend = dist.get_backend()
        reset_counts()
        mesh.recorder.reset()
        out1 = step(c_loc, lut, bsk_loc, ksk_loc)
        counts = read_counts()
        stats1 = mh.collective_stats(mesh)
        ms1 = host_ms(lambda: step(c_loc, lut, bsk_loc, ksk_loc))
        mesh.recorder.reset()
        mesh.recorder.timed = True
        rec_ms1 = host_ms(lambda: step(c_loc, lut, bsk_loc, ksk_loc))
        timed1 = mh.collective_stats(mesh)
        mesh.recorder.timed = False
    finally:
        dist.destroy_process_group()
    check(backend == "nccl", f"(a) runs under NCCL ({backend})")
    check(counts == {"K1": steps, "K2": steps, "K3": 0, "K4": 0},
          f"parallel: K1 and K2 once per rotation step ({steps}), K3/K4 never, in one sharded step ({counts})")
    # the single-process loop of external products (bootstrap.blind_rotate's loop branch)
    small = keyswitch(c.ct, sk.ksk)
    ms_ = mod_switch(small, int(math.log2(2 * n)))
    a_steps = ms_[..., :-1].movedim(-1, 0)
    acc0 = negacyclic_monomial_rotate(lut, (2 * n - ms_[..., -1])[..., None]).expand(batch, 2, n)
    acc = acc0
    for j in range(steps):
        rot = negacyclic_monomial_rotate(acc, a_steps[j][..., None])
        acc = acc + external_product(sk.bsk.bsk_ntt[j], rot - acc, PARAMS.pbs, eng, shift=sk.bsk.shift)
    ref_acc = acc
    check(torch.equal(out1, sample_extract(ref_acc, 0)), "(a) the sharded step equals the loop of external products")
    dec1 = si.decrypt(ck, si.Ciphertext(ct=out1, params=PARAMS, degree=3, noise_level=1))
    dec_lut = si.decrypt(ck, si.apply_lut(sk, c, lut, 3))
    check(bool((dec1 == want).all()) and bool((dec_lut == dec1).all()),
          "(a) the sharded step decrypts to the LUT's values, as apply_lut (K3) does")

    # K1 and K2 at the step's shapes, on its first step's inputs
    rot0 = negacyclic_monomial_rotate(acc0, a_steps[0][..., None])
    digits = signed_decompose(rot0 - acc0, PARAMS.pbs).movedim(-1, -2).reshape(batch * d_rows, n)
    fd = eng.forward_small(digits)
    k1_err = mod_err(fd, eng.forward_small_plain(digits))
    res = eng.condsub_domain(contract_residues(sk.bsk.bsk_ntt[0], fd.reshape(batch, d_rows, n_pr, n), eng))
    k2_err = exact_err(ntt_cuda.inverse(eng, res), eng.inverse_plain(res))
    check(k1_err == 0 and k2_err == 0, f"K1/K2 vs plain at the sharded step's shapes (err {k1_err}, {k2_err})")
    rows1, rows2 = batch * d_rows, batch * (PARAMS.glwe_dimension + 1)
    k1 = dict(**kernel_ms(lambda: eng.forward_small(digits), 20, "k1_forward"),
              plain_ms=cuda_ms(lambda: eng.forward_small_plain(digits), 2),
              shape=f"({rows1}, {n}) int32 -> ({rows1}, {n_pr}, {n})")
    k1["bound_ms"], k1["bound_by"] = k1_bound(rows1, n_pr, n, 4)
    k2 = dict(**kernel_ms(lambda: ntt_cuda.inverse(eng, res), 20, "k2_inverse"),
              plain_ms=cuda_ms(lambda: eng.inverse_plain(res), 2), shape=f"({rows2}, {n_pr}, {n})")
    k2["bound_ms"], k2["bound_by"] = k2_bound(rows2, n_pr, n)
    ar1 = [s for s in timed1 if s["count"] == steps]
    coll_ms1 = sum(s["seconds"] for s in timed1) * 1e3
    print(f"parallel: (a) world 1 under {backend}, make_mesh(1, 1): {ms1:.3f} ms per sharded PBS "
          f"batch of {batch} ({batch / ms1 * 1e3:.1f} PBS/s); bit-equal to the loop of external products, "
          f"decrypts as apply_lut; launches {counts}; collectives {coll_summary(stats1)}; timed run {rec_ms1:.3f} ms, "
          f"{coll_ms1:.3f} ms in collectives ({coll_ms1 / steps:.4f} ms per step, {ar1[0]['bytes'] if ar1 else 0} B "
          f"per step); K1 {k1['ms']:.4f} ms at {k1['shape']} (bound {k1['bound_ms']:.4f}, plain {k1['plain_ms']:.4f}), "
          f"K2 {k2['ms']:.4f} ms at {k2['shape']} (bound {k2['bound_ms']:.4f}, plain {k2['plain_ms']:.4f}), "
          f"{k1['timed_by']}", flush=True)

    # -- (b)-(e): one world of PAR_WORLD ranks on this card under gloo --------------
    gen = np.random.default_rng(SEED)
    xs = {}
    for nn in (2048, 4096):
        x = gen.integers(0, 2**64, nn, dtype=np.uint64)
        x[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
        xs[nn] = x
    cts_np, small_np = _u64.u64_to_numpy(c.ct), _u64.u64_to_numpy(small)
    common = dict(params=PARAMS, seed=SEED + 20, cts=cts_np, lut_table=table)
    jobs = [
        ("pbs", dict(common, n_data=1, n_model=PAR_WORLD, timed_runs=1)),
        ("ntt", dict(n_poly=2048, x=xs[2048])),
        ("ntt", dict(n_poly=4096, x=xs[4096])),
        ("rotate", dict(params=PARAMS, seed=SEED + 20, small_cts=small_np, lut_table=table)),
        ("pbs", dict(common, layout="host", n_model=1)),
        ("pbs", dict(common, layout="cross")),
    ]
    t0 = time.perf_counter()
    ranks = pl.launch(pl.run_jobs, PAR_WORLD, (jobs,), backend="gloo", ranks_per_host=1, timeout=600)
    world_s = time.perf_counter() - t0
    out1_np = _u64.u64_to_numpy(out1)

    def gathered(j):
        full = np.zeros_like(out1_np)
        for r in ranks:
            a, b = r[j]["rows"]
            full[a:b] = r[j]["out"]
        return full

    b_res = ranks[0][0]
    check(np.array_equal(gathered(0), out1_np), "(b) world 2, model width 2, bit-equal to (a)")
    ntt_err = {}
    for j, nn in ((1, 2048), (2, 4096)):
        e_ = get_folded_engine(nn, dev)
        f_ref = e_.forward_u64(_u64.u64_from_numpy(xs[nn]).to(dev)).to(torch.int64).cpu().numpy()
        f = np.concatenate([r[j]["f"] for r in sorted(ranks, key=lambda r: r[j]["coord"])], axis=1)
        back = np.concatenate([r[j]["back"] for r in sorted(ranks, key=lambda r: r[j]["coord"])], axis=1)
        ntt_err[nn] = (max(int(np.abs(f[i] % p - f_ref[i] % p).max()) for i, p in enumerate(e_.primes)),
                       max(int(np.abs(back[i] - (xs[nn] % np.uint64(p)).astype(np.int64)).max())
                           for i, p in enumerate(e_.primes)))
    check(all(v == (0, 0) for v in ntt_err.values()),
          f"(c) the sharded NTT equals K1's forward_u64 mod p and round-trips (err {ntt_err})")
    ref_acc_np = _u64.u64_to_numpy(ref_acc)
    check(all(np.array_equal(r[3]["acc"], ref_acc_np) for r in ranks), "(d) the key-sharded rotation equals (a)'s")
    check(np.array_equal(gathered(4), out1_np) and np.array_equal(gathered(5), out1_np),
          "(e) the multihost step and the cross-host model mesh's step equal (a)")
    cross_host = {name: sum(s["bytes"] * s["count"] for r in ranks for s in r[j]["stats"] if s["crosses_host"])
                  for name, j in (("host", 4), ("cross", 5))}
    check(cross_host["host"] == 0, f"(e) no collective of the multihost step crosses a host ({cross_host})")
    check(cross_host["cross"] > 0, f"(e) the cross-host model mesh's all-reduces cross hosts ({cross_host})")
    staged = sorted({s["op"] for r in ranks for j in range(len(jobs)) for s in r[j]["stats"] if s["staged"]})
    timed_b = b_res["timed_stats"]
    coll_ms2 = sum(s["seconds"] for s in timed_b) * 1e3
    ar2 = [s for s in timed_b if s["count"] == steps]
    per_rank = [r[0]["launches"] for r in ranks]
    print(f"parallel: (b)-(e) one world of {PAR_WORLD} ranks on this card under gloo, {world_s:.1f} s with spawn and "
          f"keygen (a correctness run: two ranks share one card, so its times are no scaling figure)", flush=True)
    print(f"parallel: (b) make_mesh(1, {PAR_WORLD}): the D = {d_rows} digit rows split "
          f"{' + '.join([str(d_rows // PAR_WORLD)] * PAR_WORLD)}, the KSK's n_in = {sk.ksk.n_in} rows "
          f"{' + '.join([str(sk.ksk.n_in // PAR_WORLD)] * PAR_WORLD)}; bit-equal to (a); {b_res['ms'][0]:.3f} ms per sharded PBS batch on rank 0; "
          f"collectives {coll_summary(b_res['stats'])}; timed run {b_res['recorder_timed_ms']:.3f} ms, "
          f"{coll_ms2:.3f} ms in collectives ({coll_ms2 / steps:.4f} ms per step, {ar2[0]['bytes'] if ar2 else 0} B per "
          f"step); launches per rank {per_rank}", flush=True)
    print(f"parallel: (c) make_sharded_ntt over {PAR_WORLD} ranks at N = 2048 and 4096: equal mod p to K1's "
          f"forward_u64 and round-trips (err {ntt_err}); collectives "
          + " | ".join(coll_summary(ranks[0][j]["stats"]) for j in (1, 2)), flush=True)
    print(f"parallel: (d) make_key_sharded_blind_rotate over {PAR_WORLD} ranks ({steps // PAR_WORLD} steps each): "
          f"bit-equal to (a)'s rotation on every rank; launches per rank {[r[3]['launches'] for r in ranks]}; "
          f"collectives {coll_summary(ranks[0][3]['stats'])}", flush=True)
    print(f"parallel: (e) make_multihost_pbs_step on {ranks[0][4]['shape']} (one rank a host): bit-equal to (a), "
          f"{cross_host['host']} bytes cross hosts ({coll_summary(ranks[0][4]['stats'])}); the cross-host model mesh "
          f"{ranks[0][5]['shape']}: {cross_host['cross']} bytes cross hosts ({coll_summary(ranks[0][5]['stats'])})",
          flush=True)
    print(f"parallel: staged through host memory by gloo (CUDA tensors): {staged or 'none'}", flush=True)
    print(f"parallel: summary: {ms1:.3f} ms per sharded PBS batch of {batch} at world 1 (NCCL), "
          f"{b_res['ms'][0]:.3f} ms at world {PAR_WORLD} (gloo, one card shared: a correctness run); "
          f"{ar1[0]['bytes'] if ar1 else 0} B all-reduced per rotation step, {coll_ms1 / steps:.4f} ms (world 1) and "
          f"{coll_ms2 / steps:.4f} ms (world {PAR_WORLD}) per step in collectives; launches {counts} at world 1, "
          f"{per_rank} per rank at world {PAR_WORLD}; staged through host memory: {staged or 'none'}", flush=True)
    summary = dict(batch=batch, world1_ms=ms1, world2_ms=b_res["ms"], coll_ms_per_step_world1=coll_ms1 / steps,
                   coll_ms_per_step_world2=coll_ms2 / steps, coll_bytes_per_step=ar1[0]["bytes"] if ar1 else 0,
                   staged=staged, cross_host=cross_host, world_s=world_s, launches_per_rank=per_rank)
    print(json.dumps({"parallel": dict(paths={"parallel": counts}, kernels={"K1": dict(k1, err=k1_err),
                                                                          "K2": dict(k2, err=k2_err)},
                                       summary=summary)}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.api.compact_pke import PKE_PARAMS_2M128 as PKE
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
    from tfhe_tpu_torch.ops.folded_ntt import FOLDED_PRIMES, get_folded_engine
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
    check(eng.primes == FOLDED_PRIMES, f"the parent runs the 3-prime set (TFHE_TPU_PRIMES unset), got {eng.primes}")
    primes = torch.tensor(eng.primes, device=dev).view(1, n_pr, 1)
    kern = {}
    paths = {}
    rand_i32, rand_u64, rand_key_rows, mod_err, exact_err = random_inputs(eng, SEED)

    # -- the RNG on the card against the CPU, then the 4-prime child ------------
    rng_phase(dev)
    p4 = run_child("--four-prime", {"TFHE_TPU_PRIMES": "4"})  # the 4-prime set is chosen per process
    par = run_child("--parallel")  # the NCCL world of phase (a) lives and dies in the child

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
    # K1 and K2 at the compact-PKE public key's encryption (path 8): k*N + 128
    # zero-encryptions at N = 1024, K1 on the u64 masks, K2 on its output
    eng_pke = get_folded_engine(PKE.polynomial_size, dev)
    rows_pke = PKE.glwe_dimension * PKE.polynomial_size + 128
    masks = rand_u64((rows_pke, PKE.glwe_dimension, PKE.polynomial_size))
    f_pke = eng_pke.forward_u64(masks)
    k1_pke_err = mod_err(f_pke, eng_pke.forward_u64_plain(masks))
    f_pke = f_pke[:, 0]
    k2_pke_err = exact_err(ntt_cuda.inverse(eng_pke, f_pke), eng_pke.inverse_plain(f_pke))
    check(k1_pke_err == 0 and k2_pke_err == 0,
          f"K1 (u64) and K2 vs plain at the compact-PKE key's shapes (err {k1_pke_err}, {k2_pke_err})")
    print(f"check K1 (u64) at the compact-PKE key ({rows_pke}, {PKE.glwe_dimension}, {PKE.polynomial_size}) "
          f"err {k1_pke_err}; K2 ({rows_pke}, {n_pr}, {PKE.polynomial_size}) err {k2_pke_err}", flush=True)
    del masks, f_pke
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
    keys_p3 = {"classic": dict(msb=64 - sk.bsk.shift, key_bytes=k3_key_bytes, keygen_s=keygen_s, pbs_ms=pbs_ms)}

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
    keys_p3["multibit"] = dict(msb=64 - sk.bsk.shift, key_bytes=key_bytes, keygen_s=mb_keygen_s, pbs_ms=mb_pbs_ms)

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

    # -- path 8: the fhevm API surface, create_instance + FheServer, GROUP_3 ---
    reset_counts()
    api = api_phase(dev, read_counts)
    paths["api"] = read_counts()
    ev = api["routes"]["/evaluate"]["launches"]
    check(api["params"] == MB3.name and api["pke_params"] == "V1_PKE_MESSAGE_2_CARRY_2_TUNIFORM_2M128",
          f"api: create_instance() defaults to GROUP_3 with PKE_PARAMS_2M128 ({api['params']}, {api['pke_params']})")
    check(ev["K4"] > 0 and ev["K3"] == 0, f"api: /evaluate launches K4 and not K3 ({ev})")
    print(f"api: create_instance() on the card ({api['params']}, {api['pke_params']}): keygen_s {api['keygen_s']:.3f}, "
          f"pke_keygen_s {api['pke_keygen_s']:.3f}, crs_s {api['crs_s']:.6f}; ZK prove_s "
          + ", ".join(f"{s:.3f}" for s in api["prove_s"]) + " and verify_s "
          + ", ".join(f"{s:.3f}" for s in api["verify_s"])
          + f" (host numpy, {api['input_bits']} bits a proof, {api['proof_bytes']} proof bytes); client-side compact-PKE "
          "encrypt_s " + ", ".join(f"{s:.4f}" for s in api["encrypt_s"]) + f"; /evaluate {api['ops']} ops, "
          f"{api['evaluate']}; user-decrypt client combine_s {api['user_decrypt_client_s']:.3f} over "
          f"{api['user_handles']} handles; launches {paths['api']}", flush=True)
    for route, r in api["routes"].items():
        print(f"api: {route} {r['ms'] / r['requests']:.3f} ms per request over {r['requests']} "
              f"request{'s' if r['requests'] > 1 else ''}; launches {r['launches']}", flush=True)

    # -- path 9: the ML stack, full-FHE FheSequential and the compiled module --
    ml = ml_phase(dev, reset_counts, read_counts)
    paths["ml_fhe"], paths["ml_qm"] = ml["ml_fhe_counts"], ml["ml_qm_counts"]
    kern["K3"]["max_abs_err"] = max(kern["K3"]["max_abs_err"], ml["k3"]["err"])
    b, o = k3_bound(ml["k3"]["batch"])
    kern["K3"]["ms_by_batch"][str(ml["k3"]["batch"])] = dict(ms=ml["k3"]["ms"], bound_ms=b, bound_by=o)

    # -- path 10: the ML deployment side: hybrid over HTTP, LoRA, pandas merge --
    dep = ml_deploy_phase(dev, reset_counts, read_counts, MM, MB3)
    paths.update(dep["paths"])
    kern["K4"]["max_abs_err"] = max(kern["K4"]["max_abs_err"], dep["k4_err"])

    # -- path 11: parallel/ on torch.distributed (the --parallel child) ---------
    paths.update(par["paths"])

    def par_entry(key):
        return {f: v for f, v in par["kernels"][key].items() if f != "err"}

    kern["K1"] = dict(
        name="ntt_forward", route="cuda", source="tfhe_tpu_torch/csrc/ntt.cu",
        replaces="tfhe_tpu/ops/pallas_ntt.py:494", max_abs_err=max(e3, e4, k1_err, k1u_err, k1_loop_err,
                                                                   k1_bool_err, k1_pks_err, k1_pke_err,
                                                                   ml["ntt_err"]["K1"], dep["ntt_err"]["K1"],
                                                                   par["kernels"]["K1"]["err"],
                                                                   *(v[0] for v in edge.values()),
                                                                   *(v[1] for v in edge.values())),
        path="pbs_loop", ms_by_shape={"keygen": k1_keygen, "pbs_loop": k1_loop, "boolean": k1_bool,
                                      "matmul_pks": k1_pks, "parallel": par_entry("K1")}, **{
            f: k1_loop[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")}, library_ms=None,
    )
    kern["K2"] = dict(
        name="ntt_inverse", route="cuda", source="tfhe_tpu_torch/csrc/ntt.cu",
        replaces="tfhe_tpu/ops/pallas_ntt.py:518",
        max_abs_err=max(k2_512, k2_err, k2_loop_err, k2_bool_err, k2_mask_err, k2_pke_err, ml["ntt_err"]["K2"],
                        dep["ntt_err"]["K2"], par["kernels"]["K2"]["err"],
                        *(v[2] for v in edge.values())),
        path="pbs_loop", ms_by_shape={"keygen": k2_keygen, "pbs_loop": k2_loop, "boolean": k2_bool,
                                      "matmul_mask": k2_mask, "parallel": par_entry("K2")}, **{
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
    # the 4-prime child's kernels, each beside the same kernel at P = 3 in this run
    at_p3 = {"K1": kern["K1"]["ms_by_shape"]["keygen"], "K2": kern["K2"]["ms_by_shape"]["keygen"],
             "K3": kern["K3"]["ms_by_batch"][str(BATCH)], "K4": kern["K4"]["ms_by_batch"][str(BATCH)]}
    for key, k in p4["kernels"].items():
        check(k["launches"] > 0 and k["equal"], f"{key} at P = 4 launched on its path and equal to its plain version")
        k["p3_ms"] = at_p3[key]["ms"]
        print(f"{key} at P = 4 ({k['shape']}): {k['ms']:.4f} ms against {k['p3_ms']:.4f} ms at P = 3 "
              f"(x{k['ms'] / k['p3_ms']:.3f}); bound {k['bound_ms']:.4f} by {k['bound_by']} against "
              f"{at_p3[key]['bound_ms']:.4f}; launches {k['launches']} on {k['path']}", flush=True)
    for name, p3_name in (("classic_p4", "classic"), ("multibit_p4", "multibit")):
        k4, k3 = p4["keys"][name], keys_p3[p3_name]
        print(f"keys at P = 4 against P = 3, {p3_name}: msb {k4['msb']} against {k3['msb']}; BSK {k4['key_bytes']} "
              f"against {k3['key_bytes']} bytes (x{k4['key_bytes'] / k3['key_bytes']:.3f}); keygen_s "
              f"{k4['keygen_s']:.3f} against {k3['keygen_s']:.3f}; apply_lut on {BATCH} {k4['apply_lut_ms']:.3f} "
              f"against {k3['pbs_ms']:.3f} ms", flush=True)
    kern_list = [{f: k[f] for f in order if f in k} for k in kern.values()]
    kern_list += [{f: k[f] for f in order + ("nprimes", "p3_ms") if f in k} for k in p4["kernels"].values()]
    print(json.dumps({"kernels": kern_list}), flush=True)
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
    modes = {"--four-prime": four_prime_main, "--parallel": parallel_main}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in modes else main())

"""Tracing and profiling helpers (counterpart of tfhe_tpu/utils/profiling.py).

A structured Timings registry with per-section wall clock, speed-of-light
accounting for the PBS pipeline, and a device trace over torch.profiler
(CUPTI on the card) exported as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

# H100 SXM published HBM rate (NVIDIA data sheet), bytes/s
H100_HBM_BYTES_PER_S = 3.35e12


def _synchronize(sync) -> None:
    """Call `sync` if it is callable; wait for the card if it (or what it
    returned) is a CUDA tensor."""
    r = sync() if callable(sync) else sync
    if isinstance(r, torch.Tensor) and r.is_cuda:
        torch.cuda.synchronize(r.device)


class Timings:
    """Named wall-clock sections with call counts. `sync` makes a section
    wait for the device before it stops the clock: a callable (for example
    torch.cuda.synchronize) is called, and a CUDA tensor, given or
    returned by the callable, synchronizes its device."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.total[name], 4),
                "count": self.count[name],
                "mean_ms": round(1000 * self.total[name] / self.count[name], 3),
            }
            for name in self.total
        }

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with torch.profiler (CPU activity, and the card's
    kernels where CUDA is available) and export a Chrome trace, viewable
    in Perfetto, to `logdir`/trace.json. Yields that path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def pbs_speed_of_light(params, n_primes: int = 3, n_limbs: int = 1) -> dict:
    """Roofline estimate for one PBS at `params` on one card.

    Counts the NTT butterfly multiplies and pointwise MACs, and the HBM
    bytes for streaming the bootstrap key once (the key is read in full per
    blind rotation; activations are tiny by comparison). The bound is given
    at the H100 SXM's published 3.35 TB/s; the JAX package's own bound is a
    TPU's bandwidth and has no counterpart here.
    """
    n = params.polynomial_size
    k1 = params.glwe_dimension + 1
    d = k1 * params.pbs.level
    steps = params.lwe_dimension
    log2n = n.bit_length() - 1
    # per step: D forward NTTs, k1*n_limbs inverse NTTs (per prime),
    # D*k1*n_limbs pointwise MACs (per prime)
    ntts = steps * (d + k1 * n_limbs) * n_primes
    butterflies = ntts * (n // 2) * log2n
    macs = steps * d * k1 * n_limbs * n_primes * n
    key_bytes = steps * d * k1 * n_primes * n_limbs * n * 4  # u32 residues
    return {
        "ntts": ntts,
        "butterfly_mults": butterflies,
        "pointwise_macs": macs,
        "bsk_bytes_per_pbs": key_bytes,
        "hbm_bound_pbs_per_s_at_3350GBps": round(H100_HBM_BYTES_PER_S / key_bytes, 1),
    }

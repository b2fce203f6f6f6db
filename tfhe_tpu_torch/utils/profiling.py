"""Tracing and profiling helpers (counterpart of tfhe_tpu/utils/profiling.py).

A structured Timings registry with per-section wall clock, the program's
spans (`span`, aggregated in `SPANS`), speed-of-light accounting for the
PBS pipeline, and a device trace over torch.profiler (CUPTI on the card)
of every thread, exported as a Chrome trace.

Spans are on only while a torch.profiler session is open anywhere in the
process; there is no other switch. Off, a span reads the profiler's flag
once and does nothing else. On, it enters a profiler range of its name,
so it lands in the Kineto trace of its thread on the kernels' clock, and
adds its duration to its name and its self time (duration less its
children's on the same thread) to its layer, the name's first component.
The range is torch's light one (`_RecordFunctionFast`): a tenth of
`record_function`'s cost, and no copy of the range on the device's
timeline, where it would cover the gaps between the kernels it launched.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict

import torch
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast as _Range
from torch.autograd import profiler as _autograd_profiler

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


# -- spans ----------------------------------------------------------------------

# the layers of the /evaluate path, outside in, then the GLWE matmul's routed
# experts; a span's layer is the first component of its name
LAYERS = ("client", "api", "instance", "integer", "pbs", "wait", "expert")
REQUEST_MARK = "request "  # the range that opens a request: "request <id>"


class Layer:
    """One layer's aggregates: the self time of its spans and their count."""

    def __init__(self):
        self.self_s = 0.0
        self.count = 0


class Spans(Timings):
    """Timings whose sections are the program's spans: per name the total
    duration and count (`report()`), per layer the self time and count,
    read as plain attributes (`SPANS.api.self_s`, `SPANS.api.count`)."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self.layers = {name: Layer() for name in LAYERS}

    def __getattr__(self, name):
        try:
            return self.__dict__["layers"][name]
        except KeyError:
            raise AttributeError(name) from None

    def add(self, name: str, duration_s: float, self_s: float) -> None:
        layer = name.partition(".")[0]
        with self._lock:
            self.total[name] += duration_s
            self.count[name] += 1
            agg = self.layers.get(layer) or self.layers.setdefault(layer, Layer())
            agg.self_s += self_s
            agg.count += 1

    def report(self) -> dict:
        with self._lock:  # a server thread may add a name meanwhile
            return super().report()

    def by_layer(self) -> dict:
        with self._lock:
            return {name: {"self_s": round(a.self_s, 4), "count": a.count} for name, a in self.layers.items()}


SPANS = Spans()
_tls = threading.local()  # .stack: the thread's open spans
_request_ids = itertools.count(1)


def _open(name: str) -> list:
    rf = _Range(name)
    rf.__enter__()
    frame = [name, 0.0, rf, time.perf_counter()]  # name, children's seconds, range, start
    _tls.__dict__.setdefault("stack", []).append(frame)
    return frame


def _close(frame: list) -> None:
    t1 = time.perf_counter()
    name, child_s, rf, t0 = frame
    stack = _tls.stack
    stack.pop()
    dt = t1 - t0
    if stack:
        stack[-1][1] += dt
    SPANS.add(name, dt, dt - child_s)
    rf.__exit__(None, None, None)


class span:
    """A span of the program named "<layer>.<what>", as a context manager
    (a new one per `with`) or as a decorator. Off (no profiler session
    open), entering it reads `_is_profiler_enabled` once and does nothing
    else: no `record_function`, no change to SPANS."""

    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name = name
        self._frame = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._frame = _open(self.name)
        return self

    def __exit__(self, *exc):
        if self._frame is not None:
            _close(self._frame)
            self._frame = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            frame = _open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _close(frame)

        return spanned


def new_request() -> None:
    """Start a request on the calling thread: a range "request <id>", with
    a fresh id, marks its start in the trace, and `device_trace` writes
    that id into the args of every span the thread opens after it. Off,
    one read of the profiler's flag."""
    if _autograd_profiler._is_profiler_enabled:
        with _Range(f"{REQUEST_MARK}r{next(_request_ids)}"):
            pass


def _tag_requests(path: str) -> None:
    """Write into the args of each span in the Chrome trace at `path` the
    id of the request it belongs to: the latest "request <id>" range
    opened on its thread before it."""
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("cat") in ("user_annotation", "cpu_op") and e.get("ph") == "X"]
    marks = defaultdict(list)  # tid -> [(ts, id)]
    for e in events:
        if e["name"].startswith(REQUEST_MARK):
            marks[e["tid"]].append((e["ts"], e["name"][len(REQUEST_MARK):]))
    if not marks:
        return
    starts = {}
    for tid, m in marks.items():
        m.sort()
        starts[tid] = [ts for ts, _ in m]
    for e in events:
        i = bisect.bisect_right(starts.get(e["tid"], []), e["ts"])
        if i and e["name"].partition(".")[0] in SPANS.layers:
            e.setdefault("args", {})["request"] = marks[e["tid"]][i - 1][1]
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with torch.profiler (CPU activity of every thread,
    and the card's kernels where CUDA is available) and export a Chrome
    trace, viewable in Perfetto, to `logdir`/trace.json, each span tagged
    with its request id. Yields that path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    _tag_requests(path)


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

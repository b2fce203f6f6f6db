"""The traced run's reader: torch.profiler over the measured window, reduced
to the device's busy time, device time by kernel, and idle time by what the
host was doing.

The profiler starts after set-up and a synchronise, and stops after the
window's last synchronise, so every device event it records belongs to the
window. The harness marks its own steps with `record_function` ranges
(`span`); an idle gap is named by the innermost host range that covers its
midpoint: a torch op of the program on any thread, else the harness's
range, else "host".
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

WINDOW = "bench.window"
SPAN_PREFIX = "bench."


def span(name: str):
    """A harness range in the trace (a no-op cost when no profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def short(kernel: str) -> str:
    """A kernel's name without namespaces, template arguments and launch
    parameters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "at::detail::", "c10::"):
        kernel = kernel.replace(junk, "")
    return kernel.split("(")[0].split("<")[0][:80]


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict  # short kernel name -> device seconds
    kernel_n: dict  # short kernel name -> events
    idle_by_host: dict  # host label -> idle seconds

    def top(self, d: dict, k: int = 10) -> list:
        return [[name, s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def share_outside(tr: TraceSummary | None, kernels: tuple) -> float | None:
    """Device time outside the named kernels as a share (%) of the traced
    window; None without a trace."""
    if tr is None or tr.window_s <= 0:
        return None
    inside = sum(s for name, s in tr.kernel_s.items() if name in kernels)
    return 100.0 * (tr.busy_s - inside) / tr.window_s


@contextlib.contextmanager
def traced(out: dict):
    """Profile the block; on exit out["trace"] holds its TraceSummary, or
    None where the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            sync()
    out["trace"] = summarize(raw_events(prof))


def raw_events(prof) -> list:
    """(name, on the device, start us, end us) of every event the profiler
    kept, read from its raw results under the names and with the filter of
    torch's own event list, which builds a Python object and a call tree for
    each event: minutes at the million events of a long window."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names, out = {}, []
    for ev in res.events():
        raw = ev.name()
        if _filter_name(raw) or ev.is_hidden_event():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = _rewrite_name(raw, with_wildcard=True)
        on_device = str(ev.device_type()).endswith("CUDA")
        out.append((name, on_device, (ev.start_ns() - t0) / 1e3, (ev.end_ns() - t0) / 1e3))
    return out


def _merge(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


LOOKBACK = 64


def _covering(ranges: list, t: float) -> str | None:
    i = bisect.bisect_right(ranges, (t, float("inf"), ""))
    for s, e, name in reversed(ranges[max(0, i - LOOKBACK):i]):
        if e >= t:
            return name
    return None


def summarize(events) -> TraceSummary | None:
    """events: (name, on the device, start us, end us), as `raw_events`
    gives them."""
    window = [(s, e) for name, on_device, s, e in events if name == WINDOW and not on_device]
    if len(window) != 1:
        return None
    w0, w1 = window[0]
    dev, host = [], []
    kernel_s, kernel_n = {}, {}
    for name, on_device, start, end in events:
        if on_device:
            # range annotations also appear on the device timeline
            if name.startswith(SPAN_PREFIX) or name.startswith("ProfilerStep"):
                continue
            s, e = max(start, w0), min(end, w1)
            if e <= s:
                continue
            dev.append((s, e))
            name = short(name)
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e6
            kernel_n[name] = kernel_n.get(name, 0) + 1
        elif name != WINDOW:
            host.append((start, end, name))
    if not dev:
        return None
    busy = _merge(dev)
    busy_us = sum(e - s for s, e in busy)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    # the innermost range covering a point is the latest-starting one that
    # ends after it; look back over the last LOOKBACK ranges that started
    # before the point
    ours = sorted((s, e, n[len(SPAN_PREFIX):]) for s, e, n in host if n.startswith(SPAN_PREFIX))
    theirs = sorted(h for h in host if not h[2].startswith(SPAN_PREFIX))
    idle = {}
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        label = _covering(theirs, mid) or _covering(ours, mid) or "host"
        idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e6
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, kernel_s=kernel_s,
                        kernel_n=kernel_n, idle_by_host=idle)

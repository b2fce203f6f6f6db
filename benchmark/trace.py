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
    out["trace"] = summarize(prof.events())


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
    window = [ev for ev in events if ev.name == WINDOW and str(ev.device_type).endswith("CPU")]
    if len(window) != 1:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev, host = [], []
    kernel_s, kernel_n = {}, {}
    for ev in events:
        if str(ev.device_type).endswith("CUDA"):
            # range annotations also appear on the device timeline
            if ev.name.startswith(SPAN_PREFIX) or ev.name.startswith("ProfilerStep"):
                continue
            s, e = max(ev.time_range.start, w0), min(ev.time_range.end, w1)
            if e <= s:
                continue
            dev.append((s, e))
            name = short(ev.name)
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e6
            kernel_n[name] = kernel_n.get(name, 0) + 1
        elif ev.name != WINDOW:
            host.append((ev.time_range.start, ev.time_range.end, ev.name))
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

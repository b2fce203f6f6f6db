"""The traced run's reduction: the profiler's raw events read as torch's own
event list gives them (less its merging of nested same-name ops, which
changes no kernel time and no idle gap's name), and their summary (busy
time, device time by kernel, idle time by the host range covering it)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace


def test_raw_events_are_torch_event_list():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with trace.span("matmul"):
                (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    raw = trace.raw_events(prof)
    ref = [(e.name, str(e.device_type).endswith("CUDA"), e.time_range.start, e.time_range.end) for e in prof.events()]
    assert set(ref) <= set(raw)
    # torch's list drops an op nested alone in an op of its own name (a dispatch step); nothing else differs
    for name, on_device, start, end in set(raw) - set(ref):
        assert any(n == name and d == on_device and s <= start and end <= e for n, d, s, e in ref), name
    assert any(name == trace.WINDOW for name, *_ in raw)


def test_summarize():
    """Window 0-100 us; kernels at 10-30, 20-40 (overlapping) and 60-70;
    the gaps 0-10 (nothing covers it), 40-60 (a torch op) and 70-100 (the
    harness's span)."""
    foo = "void at::native::foo<int>(int*)"
    events = [(trace.WINDOW, False, 0.0, 100.0), (foo, True, 10.0, 30.0), (foo, True, 20.0, 40.0),
              ("k1_forward", True, 60.0, 70.0), ("aten::add", False, 38.0, 61.0), ("bench.matmul", False, 65.0, 100.0),
              ("bench.matmul", True, 65.0, 100.0)]
    tr = trace.summarize(events)
    assert tr.window_s == pytest.approx(1e-4) and tr.busy_s == pytest.approx(4e-5)
    assert tr.kernel_s == pytest.approx({"foo": 4e-5, "k1_forward": 1e-5}) and tr.kernel_n == {"foo": 2, "k1_forward": 1}
    assert tr.idle_by_host == pytest.approx({"host": 1e-5, "aten::add": 2e-5, "matmul": 3e-5})
    assert trace.share_outside(tr, ("k1_forward",)) == pytest.approx(30.0)
    assert trace.summarize([(trace.WINDOW, False, 0.0, 1.0)]) is None  # no device activity

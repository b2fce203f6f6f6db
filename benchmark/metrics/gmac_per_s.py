"""Multiply-accumulates of the window's matmuls (rows x inner x out each)
over the window's seconds, in units of 10^9."""


def read(run):
    macs = run.facts.get("macs")
    return macs / run.window_s / 1e9 if macs else None

"""Transfers whose /evaluate answered in the window over the window's
seconds; the window ends at the answer of the last request started before
the deadline."""


def read(run):
    n = run.facts.get("transfers")
    return n / run.window_s if n else None

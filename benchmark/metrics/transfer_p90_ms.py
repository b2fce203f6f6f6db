"""The 90th percentile, over every request of the window, of submission to
answer (statistics.quantiles, inclusive method)."""

import statistics


def read(run):
    lat = run.facts.get("latencies_s") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8] * 1e3

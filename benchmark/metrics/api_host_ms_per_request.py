"""Host milliseconds an /evaluate spends in the server's own layers: the
self time of the program's `api` and `instance` spans (HTTP, JSON, the
dependency waves and buckets, gathering operands, handles and gas costs;
not the radix ops, the PBS or the waits on the card) over the window, per
request. Spans run only while a profiler session is open, as in a traced
run; a program without them refuses the run."""

PROFILING = "tfhe_tpu_torch.utils.profiling"
COUNTERS = {"api_self_s": f"{PROFILING}:SPANS.api.self_s",
            "instance_self_s": f"{PROFILING}:SPANS.instance.self_s",
            "api_spans": f"{PROFILING}:SPANS.api.count"}


def read(run):
    n = run.facts.get("attempted")
    if not n or not run.counters.get("api_spans"):
        return None
    return 1e3 * (run.counters["api_self_s"] + run.counters["instance_self_s"]) / n

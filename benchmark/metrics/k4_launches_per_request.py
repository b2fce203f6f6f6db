"""K4 launches (the group-step wrapper's counter) over the window, per
/evaluate request."""

COUNTERS = {"K4": "tfhe_tpu_torch.ops.multibit_cuda:group_steps.launches"}


def read(run):
    n = run.facts["attempted"]
    return run.counters["K4"] / n if n else None

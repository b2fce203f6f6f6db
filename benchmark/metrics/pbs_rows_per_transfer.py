"""PBS rows the integer layer ran (`models/integer._pbs.rows`) over the
window, per transfer. Missing where the path bypasses that counter."""

COUNTERS = {"pbs_rows": "tfhe_tpu_torch.models.integer:_pbs.rows"}


def read(run):
    rows, n = run.counters.get("pbs_rows"), run.facts.get("transfers")
    return rows / n if rows and n else None

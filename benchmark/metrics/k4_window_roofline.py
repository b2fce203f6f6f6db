"""K4's share of its roofline over the whole window, at whatever batch
each launch had: the frozen operation and byte counts
(benchmark/roofline.py) summed over the window's K4 rows and launches,
operations on the rows, bytes on the rows plus the key once a launch, and
the larger of the two bounds over K4's device time in the trace. At one
batch size it equals `k4_roofline`; over mixed batches the sum of each
launch's own bound is at least this, so the share reads low, never high.
Missing where the trace holds another number of K4 launches than the
wrapper counted."""

from benchmark import roofline

KERNEL = "k4_group_steps"
COUNTERS = {"K4": "tfhe_tpu_torch.ops.multibit_cuda:group_steps.launches",
            "K4_rows": "tfhe_tpu_torch.ops.multibit_cuda:group_steps.rows"}


def read(run):
    tr, n, rows = run.trace, run.counters.get("K4"), run.counters.get("K4_rows")
    if tr is None or not n or not rows or tr.kernel_n.get(KERNEL) != n:
        return None
    c = run.cell.config
    g, n_pr, poly = c["grouping_factor"], c["crt_primes"], c["polynomial_size"]
    groups = c["lwe_dimension"] // g
    ops = roofline.group_step_ops(rows, groups, g, n_pr, poly)
    n_bytes = (roofline.rotation_bytes(rows, groups, g, 0, poly)
               + n * roofline.key_bytes(groups << g, n_pr, poly))
    return 100.0 * roofline.bound_s(n_bytes, ops) / tr.kernel_s[KERNEL]

"""K4's share of its roofline: the frozen bound of one launch on the
traffic's batch (benchmark/roofline.py) times the launches, over K4's
device time in the trace. Missing where the trace holds another number of
K4 launches than the wrapper counted."""

from benchmark import roofline

COUNTERS = {"K4": "tfhe_tpu_torch.ops.multibit_cuda:group_steps.launches"}
KERNEL = "k4_group_steps"


def read(run):
    tr, n = run.trace, run.counters.get("K4")
    if tr is None or not n or tr.kernel_n.get(KERNEL) != n:
        return None
    c = run.cell.config
    bound = roofline.k4_bound_s(run.cell.traffic["batch"], c["lwe_dimension"], c["grouping_factor"],
                                c["crt_primes"], c["polynomial_size"])
    return 100.0 * bound * n / tr.kernel_s[KERNEL]

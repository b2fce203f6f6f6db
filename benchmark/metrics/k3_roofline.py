"""K3's share of its roofline: the frozen bound of one launch on the
traffic's batch (benchmark/roofline.py) times the launches, over K3's
device time in the trace. Missing where the trace holds another number of
K3 launches than the wrapper counted."""

from benchmark import roofline

COUNTERS = {"K3": "tfhe_tpu_torch.ops.blind_rotate_cuda:cmux_steps.launches"}
KERNEL = "k3_cmux"


def read(run):
    tr, n = run.trace, run.counters.get("K3")
    if tr is None or not n or tr.kernel_n.get(KERNEL) != n:
        return None
    c = run.cell.config
    bound = roofline.k3_bound_s(run.cell.traffic["batch"], c["lwe_dimension"], c["crt_primes"],
                                c["polynomial_size"])
    return 100.0 * bound * n / tr.kernel_s[KERNEL]

"""The matmuls' share of their roofline over the traced window: the frozen
bound of one matmul at each layer's shape (benchmark/roofline.py) times the
window's matmuls of that layer, summed, over the window's seconds. It reads
the same work whatever kernels do it."""

from benchmark import roofline


def read(run):
    tr, calls = run.trace, run.facts.get("layer_calls")
    if tr is None or not calls or tr.window_s <= 0:
        return None
    c, t = run.cell.config, run.cell.traffic
    bound = sum(calls[layer["name"]] * roofline.matmul_bound_s(
        t["rows"], layer["inner"], layer["out"], c["glwe_dimension"], c["crt_primes"], c["polynomial_size"],
        c["packing_ks_level"]) for layer in t["layers"])
    return 100.0 * bound / tr.window_s

"""The routed experts' share of their roofline over the traced window: the
least time the card could take for the window's grouped calls
(`glwe_matmul.expert_matmul`), over the window's seconds, whatever kernels
do the work. Composed from the frozen matmul counts
(benchmark/roofline.py) a call at a time: the matmul of its pairs (each
pair's products, extraction, packing keyswitch and switch, as a row of
`matmul_ops`), with the input transforms counted once a routed row and
not once a pair, and the bytes of each expert with pairs read once a call;
the operations and the bytes summed over the window, and the larger of
their two bounds taken. Missing where the program's pair counter
disagrees with the pairs the traffic routed."""

from benchmark import roofline

COUNTERS = {"pairs": "tfhe_tpu_torch.models.glwe_matmul:expert_matmul.pairs"}


def read(run):
    tr, calls = run.trace, run.facts.get("calls")
    if tr is None or not calls or tr.window_s <= 0 or run.counters.get("pairs") != run.facts.get("pairs"):
        return None
    c = run.cell.config
    k, n_pr, n, level = c["glwe_dimension"], c["crt_primes"], c["polynomial_size"], c["packing_ks_level"]
    hidden, inter = c["hidden_size"], c["moe_intermediate_size"]
    shapes = {"gate_up": (hidden, 2 * inter), "down": (inter, hidden)}
    ops = n_bytes = 0.0
    for kind, pairs, rows, experts in calls:
        inner, out = shapes[kind]
        chunks = -(-inner // n)

        def b(r, o):
            return roofline.matmul_bytes(r, inner, o, k, n_pr, n, level)

        key = b(0, 0)
        ops += (roofline.matmul_ops(pairs, inner, out, k, n_pr, n, level)
                - roofline.ntt_ops(pairs * chunks * (k + 1), n_pr, n) + roofline.ntt_ops(rows * chunks * (k + 1), n_pr, n))
        n_bytes += (key + experts * (b(0, out) - key) + rows * (b(1, 0) - key)
                    + b(pairs, out) - b(pairs, 0) - (b(0, out) - key))
    return 100.0 * roofline.bound_s(n_bytes, ops) / tr.window_s

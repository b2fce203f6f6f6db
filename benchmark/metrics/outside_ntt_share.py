"""Device time outside the transform kernels (K1 `k1_forward`, K2
`k2_inverse`) as a share of the traced window: the matmul's one-to-many
Shoup products and their sums, the body's coefficient, the Garner, the
packing keyswitch's decomposition and MAC, and the glue around them."""

from benchmark.trace import share_outside


def read(run):
    return share_outside(run.trace, ("k1_forward", "k2_inverse"))

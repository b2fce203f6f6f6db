"""Device time outside the rotation kernels (K3 `k3_cmux`, K4
`k4_group_steps`) as a share of the traced window: the keyswitch, the
accumulator set-up, sample extraction and the glue around them."""

from benchmark.trace import share_outside


def read(run):
    return share_outside(run.trace, ("k3_cmux", "k4_group_steps"))

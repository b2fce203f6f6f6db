"""Device time outside the rotation kernels (K3 `k3_cmux`, K4
`k4_group_steps`) as a share of the traced window: the keyswitch, the
accumulator set-up, sample extraction and the glue around them."""

ROTATION = ("k3_cmux", "k4_group_steps")


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    rot = sum(s for name, s in tr.kernel_s.items() if name in ROTATION)
    return 100.0 * (tr.busy_s - rot) / tr.window_s

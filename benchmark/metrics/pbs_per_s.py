"""PBS completed in the window over the window's seconds."""


def read(run):
    pbs = run.facts.get("pbs")
    return pbs / run.window_s if pbs else None

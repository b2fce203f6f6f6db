"""Set-up seconds: process start to the window's start (imports, CUDA
start-up, the kernels' build where a checkout has none yet, keygen, inputs,
warm-up)."""


def read(run):
    return run.setup_s

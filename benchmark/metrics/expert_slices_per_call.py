"""Slices a grouped expert call (`glwe_matmul.expert_matmul`) ran over the
window, each under one packing keyswitch: how far the workspace budget
splits a call."""

MATMUL = "tfhe_tpu_torch.models.glwe_matmul"
COUNTERS = {"slices": f"{MATMUL}:expert_matmul.slices", "calls": f"{MATMUL}:expert_matmul.calls"}


def read(run):
    calls = run.counters.get("calls")
    return run.counters["slices"] / calls if calls else None

"""Device selection: the port's entry points run on the card unless the
caller asks for the CPU. There is no silent fallback."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` (default "cuda") as a torch.device; raises when CUDA is
    asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tfhe_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

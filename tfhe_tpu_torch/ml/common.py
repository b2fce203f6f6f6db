"""Shared ML-layer plumbing (a copy of tfhe_tpu/ml/common.py).

FheMode mirrors the reference's execution-mode switch (reference:
ml/concrete-ml/src/concrete/ml/common/utils.py:64-104 FheMode
DISABLE/SIMULATE/EXECUTE): DISABLE runs the quantized pipeline in the
clear, SIMULATE adds analytically-sampled noise without crypto, EXECUTE
runs real encrypted compute.
"""

from __future__ import annotations

import enum


class FheMode(str, enum.Enum):
    DISABLE = "disable"
    SIMULATE = "simulate"
    EXECUTE = "execute"

    @staticmethod
    def from_any(v) -> "FheMode":
        if isinstance(v, FheMode):
            return v
        return FheMode(str(v).lower())

"""Polynomial engines and the CUDA kernel wrappers."""

from tfhe_tpu_torch.ops.polynomial import NegacyclicEngine, get_engine
from tfhe_tpu_torch.ops.folded_ntt import FoldedCrtEngine, get_folded_engine

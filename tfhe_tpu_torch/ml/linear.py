"""Encrypted linear-layer executor over the GLWE matmul (counterpart of
tfhe_tpu/ml/linear.py, the analog of concrete-ml's GLWELinearLayerExecutor).

Dynamic activation quantization, symmetric weight quantization, and three
modes over the same integer pipeline: DISABLE computes the quantized
product in the clear, SIMULATE adds the analytic noise profile
(noise.find_noise_profile), EXECUTE encrypts, multiplies on the port's
glwe_matmul (K1/K2 on the card) and decrypts. The executor is a dataclass,
not a torch module: its weights are quantized integers, not trainable
parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.quantization import UniformQuantizer
from tfhe_tpu_torch.models import glwe_matmul as gm
from tfhe_tpu_torch.params import MatmulParams


@dataclasses.dataclass
class GlweLinearLayerExecutor:
    weights: np.ndarray  # (C, O) float
    bias: np.ndarray | None = None  # (O,)
    n_bits_in: int = 8
    n_bits_w: int = 8
    params: MatmulParams | None = None
    exact_int_weights: bool = False  # weights already small ints: scale 1
    _pkey: object = None

    def __post_init__(self):
        if self.params is None:
            self.params = gm.default_params()
        self.w_quant = UniformQuantizer(self.n_bits_w, is_signed=True)
        if self.exact_int_weights:
            # selector matrices and pre-quantized integer weights keep scale 1
            self.w_quant.scale = np.float64(1.0)
            self.w_quant.zero_point = np.float64(0.0)
        else:
            # symmetric (zero_point 0) keeps the encrypted accumulation free
            # of weight offsets; scale max|w|/qmax does not clip one-sided
            # weight matrices
            amax = float(np.abs(np.asarray(self.weights, np.float64)).max())
            self.w_quant.scale = np.float64(amax / self.w_quant.qmax or 1.0)
            self.w_quant.zero_point = np.float64(0.0)
        self.w_q = self.w_quant.quant(self.weights)

    def keygen(self, seed: int = 0, device=None):
        """The matmul keys on `device` (default "cuda")."""
        self._pkey = gm.create_private_key(self.params, seed=seed, device=device)
        return self

    def forward(self, x: np.ndarray, fhe: FheMode | str = FheMode.DISABLE) -> np.ndarray:
        """x: (B, C) float -> (B, O) float."""
        fhe = FheMode.from_any(fhe)
        x = np.asarray(x, dtype=np.float64)
        xq = UniformQuantizer(self.n_bits_in, is_signed=False).fit(x)
        # the quantizer is batch-dynamic; kept for callers that reason on
        # the integer grid
        self.last_input_quantizer = xq
        x_q = xq.quant(x)  # (B, C) in [0, 2^b)

        if fhe == FheMode.EXECUTE:
            if self._pkey is None:
                raise RuntimeError("call keygen() first")
            enc = gm.encrypt_matrix(self._pkey, x_q.astype(np.uint64))
            res = gm.matrix_multiplication(enc, self.w_q, self._pkey)
            acc = gm.decrypt_matrix(res, self._pkey).cpu().numpy().astype(np.float64)
        else:
            acc = x_q.astype(np.float64) @ self.w_q.astype(np.float64)
            if fhe == FheMode.SIMULATE:
                # std in accumulator LSBs, dominated by the output storage
                # modulus switch
                from tfhe_tpu_torch.noise import find_noise_profile

                std = find_noise_profile(self.params, x.shape[-1])
                rs = np.random.RandomState(0)
                acc = acc + rs.normal(0.0, std, size=acc.shape).round()

        # undo the input zero-point with the clear per-column weight sums
        w_col = self.w_q.sum(axis=0).astype(np.float64)
        acc = acc - float(xq.zero_point) * w_col
        y = acc * float(xq.scale) * np.asarray(self.w_quant.scale, np.float64)
        if self.bias is not None:
            y = y + np.asarray(self.bias, np.float64)
        return y

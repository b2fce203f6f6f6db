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


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


@dataclasses.dataclass
class GlweExpertsExecutor:
    """Routed SiLU-gated experts, down(SiLU(gate x) * up x), on the GLWE
    matmul's grouped call (glwe_matmul.expert_matmul). It holds the routed
    experts `held` (their ids; gate/up/down lists in that order), then any
    shared experts, all of one intermediate width I.

    Each matrix is quantized as GlweLinearLayerExecutor's weights; each
    expert's gate and up are one (C, 2I) matrix. A forward takes the token
    rows and the (token, local expert) pairs the client routed: EXECUTE
    encrypts the tokens once and runs gate and up as one grouped call; the
    client decrypts, computes SiLU(gate) * up in the clear, quantizes and
    encrypts it a pair a row, and down runs as a second grouped call.
    DISABLE runs the same integer pipeline in the clear."""

    gate: list  # per expert (C, I) float
    up: list  # per expert (C, I) float
    down: list  # per expert (I, C) float
    held: tuple = ()  # ids of the routed experts, the first len(held) entries
    n_bits_in: int = 8
    n_bits_w: int = 8
    params: MatmulParams | None = None
    _pkey: object = None

    def __post_init__(self):
        if self.params is None:
            self.params = gm.default_params()
        self.held = tuple(self.held)

        def quantized(w):
            lin = GlweLinearLayerExecutor(weights=np.asarray(w, np.float64), n_bits_w=self.n_bits_w,
                                          params=self.params)
            return lin.w_q, np.full(lin.w_q.shape[1], float(lin.w_quant.scale))

        gu = [[quantized(g), quantized(u)] for g, u in zip(self.gate, self.up)]
        self.w_gate_up = [np.concatenate([g[0], u[0]], axis=1) for g, u in gu]  # (C, 2I) ints
        self.s_gate_up = np.stack([np.concatenate([g[1], u[1]]) for g, u in gu])  # (E, 2I)
        dq = [quantized(d) for d in self.down]
        self.w_down = [w for w, _ in dq]  # (I, C) ints
        self.s_down = np.stack([s for _, s in dq])  # (E, C)
        self._prepared = None

    @property
    def n_shared(self) -> int:
        return len(self.gate) - len(self.held)

    def keygen(self, seed: int = 0, device=None):
        """The matmul keys and the prepared experts on `device` (default
        "cuda")."""
        from tfhe_tpu_torch.rng import FheRng

        self._pkey = gm.create_private_key(self.params, seed=seed, device=device)
        dev = self._pkey.device
        self._rng = FheRng(seed + 1, dev)  # fresh masks for every encryption
        self._prepared = (
            [gm.prepare_clear_weights(self.params, w, device=dev) for w in self.w_gate_up],
            [gm.prepare_clear_weights(self.params, w, device=dev) for w in self.w_down],
        )
        return self

    def _grouped(self, x: np.ndarray, which: int, rows, experts, fhe: FheMode) -> np.ndarray:
        """x (R, C) float through expert experts[i] for row rows[i] of each
        pair, gate|up (which 0) or down (which 1) -> (pairs, O) float."""
        w_q, scale = (self.w_gate_up, self.s_gate_up) if which == 0 else (self.w_down, self.s_down)
        xq = UniformQuantizer(self.n_bits_in, is_signed=False).fit(x)
        x_q = xq.quant(x)
        if fhe == FheMode.EXECUTE:
            if self._pkey is None:
                raise RuntimeError("call keygen() first")
            enc = gm.encrypt_matrix(self._pkey, x_q.astype(np.uint64), rng=self._rng)
            routing = np.stack([rows, experts], axis=1)
            res = gm.expert_matmul(enc, self._prepared[which], routing, self._pkey)
            acc = gm.decrypt_matrix(res, self._pkey).cpu().numpy().astype(np.float64)
        elif fhe == FheMode.DISABLE:
            acc = np.stack([x_q[r].astype(np.float64) @ w_q[e] for r, e in zip(rows, experts)]).reshape(
                len(rows), w_q[0].shape[1])
        else:
            raise NotImplementedError("GlweExpertsExecutor runs DISABLE and EXECUTE")
        col = np.stack([w_q[e].sum(axis=0) for e in experts]).reshape(acc.shape).astype(np.float64)
        return (acc - float(xq.zero_point) * col) * float(xq.scale) * scale[experts]

    def forward(self, x: np.ndarray, tokens, experts, fhe: FheMode | str = FheMode.DISABLE) -> np.ndarray:
        """x (T, C) float; pair i sends token tokens[i] to local expert
        experts[i] (0 .. len(held)-1 the routed experts, then the shared
        ones) -> each pair's expert output (pairs, C), unweighted."""
        fhe = FheMode.from_any(fhe)
        tokens, experts = np.asarray(tokens, np.int64), np.asarray(experts, np.int64)
        if len(tokens) == 0:
            return np.zeros((0, self.w_down[0].shape[1]))
        gu = self._grouped(np.asarray(x, np.float64), 0, tokens, experts, fhe)
        width = gu.shape[1] // 2
        h = _silu(gu[:, :width]) * gu[:, width:]  # the client's step, in the clear
        return self._grouped(h, 1, np.arange(len(tokens)), experts, fhe)

"""Hybrid FHE model: run selected torch linear layers encrypted
(counterpart of tfhe_tpu/ml/hybrid.py).

Analog of the reference's HybridFHEModel (reference:
ml/concrete-ml/src/concrete/ml/torch/hybrid_model.py:106,379,587 -- wrap a
torch network, swap named nn.Linear modules for remote/FHE executors, keep
the rest local) and its server half (:821 HybridFHEModelServer). Used for
LLM-style deployments where only the projection matrices are private.

The swapped layer routes through GlweLinearLayerExecutor; `fhe=` selects
disable/simulate/execute per call. A swapped layer returns its output on
the input tensor's device and in its dtype.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.hybrid_server import RemoteModule, linear_executor
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor


def _locate(model, dotted: str):
    """(parent module, attribute name) of a dotted submodule name."""
    parts = dotted.split(".")
    obj = model
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


def _linear_at(model, name: str) -> tuple:
    parent, attr = _locate(model, name)
    lin = getattr(parent, attr)
    if not isinstance(lin, torch.nn.Linear):
        raise TypeError(f"{name} is not Linear")
    return parent, attr, lin


def _like(y: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """A numpy result as a tensor on x's device in x's dtype."""
    return torch.from_numpy(np.ascontiguousarray(y)).to(device=x.device, dtype=x.dtype)


class FheLinearModule(torch.nn.Module):
    """An nn.Linear executed by a GlweLinearLayerExecutor in mode `fhe`."""

    def __init__(self, executor: GlweLinearLayerExecutor):
        super().__init__()
        self.executor = executor
        self.fhe = FheMode.DISABLE

    def forward(self, x):
        xp = x.detach().cpu().numpy()
        y = self.executor.forward(xp.reshape(-1, xp.shape[-1]), fhe=self.fhe)
        return _like(y.reshape(*xp.shape[:-1], y.shape[-1]), x)


class RemoteLinearModule(torch.nn.Module):
    """An nn.Linear executed remotely by a RemoteModule."""

    def __init__(self, remote: RemoteModule):
        super().__init__()
        self._remote = remote

    def forward(self, x):
        return _like(self._remote.forward(x.detach().cpu().numpy()), x)


class HybridFHEModel:
    """Wraps a torch module; `module_names` linear layers run under FHE."""

    def __init__(self, model, module_names: Iterable[str], params=None, n_bits: int = 8):
        self.model = model
        self.module_names = list(module_names)
        self._fhe_layers: dict[str, FheLinearModule] = {}
        for name in self.module_names:
            parent, attr, lin = _linear_at(model, name)
            layer = FheLinearModule(linear_executor(lin, params, n_bits))
            self._fhe_layers[name] = layer
            setattr(parent, attr, layer)

    def compile(self, seed: int = 0, device=None):
        """Generate keys for every FHE layer on `device` (default "cuda")."""
        for i, layer in enumerate(self._fhe_layers.values()):
            layer.executor.keygen(seed + i, device=device)
        return self

    def forward(self, x, fhe: FheMode | str = FheMode.DISABLE):
        fhe = FheMode.from_any(fhe)
        for layer in self._fhe_layers.values():
            layer.fhe = fhe
        return self.model(x)

    __call__ = forward


def serve_hybrid_model(model, module_names: Iterable[str], model_name: str, server, params=None) -> None:
    """Server side of the hybrid deployment: register every named
    nn.Linear of `model` with a HybridFHEModelServer (reference
    hybrid_model.py:379 compile_model + :821 server registry). The
    weights live only on the server after this. `params` picks the
    GLWE matmul parameter set (default: production)."""
    for name in module_names:
        _, _, lin = _linear_at(model, name)
        server.register(model_name, name, lin, params=params)


class RemoteHybridModel:
    """Client half: a torch model whose named linear layers are executed
    REMOTELY over a transport (reference RemoteModule,
    hybrid_model.py:122: activations encrypted client-side, weights never
    leave the server). The local copies of the swapped layers are
    discarded -- their parameters are irrelevant. The client keys live on
    `device` (default "cuda")."""

    def __init__(self, model, module_names: Iterable[str], model_name: str, transport, key_seed: int = 0,
                 device=None):
        self.model = model
        self.remotes: dict[str, RemoteModule] = {}
        for name in module_names:
            parent, attr = _locate(model, name)
            remote = RemoteModule(transport, model_name, name, key_seed=key_seed, device=device)
            self.remotes[name] = remote
            setattr(parent, attr, RemoteLinearModule(remote))

    def forward(self, x):
        return self.model(x)

    __call__ = forward

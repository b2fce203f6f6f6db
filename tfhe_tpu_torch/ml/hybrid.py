"""Hybrid FHE model: run selected torch linear layers encrypted
(counterpart of tfhe_tpu/ml/hybrid.py).

Analog of the reference's HybridFHEModel (reference:
ml/concrete-ml/src/concrete/ml/torch/hybrid_model.py:106,379,587 -- wrap a
torch network, swap named nn.Linear modules for remote/FHE executors, keep
the rest local) and its server half (:821 HybridFHEModelServer). Used for
LLM-style deployments where only the projection matrices are private.

The swapped layer routes through GlweLinearLayerExecutor; `fhe=` selects
disable/simulate/execute per call. A swapped layer returns its output on
the input tensor's device and in its dtype. A mixture-of-experts block
(DeepSeek-V2's `DeepseekV2MoE`: `gate`, `experts`, `shared_experts`) is
swapped whole: its router and the weighted combine stay on the client in
the clear, and the experts it holds run on a GlweExpertsExecutor.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.hybrid_server import RemoteModule, linear_executor
from tfhe_tpu_torch.ml.linear import GlweExpertsExecutor, GlweLinearLayerExecutor


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


def _weight(lin: torch.nn.Linear) -> np.ndarray:
    return lin.weight.detach().cpu().numpy().astype(np.float64).T  # (in, out)


class FheMoEModule(torch.nn.Module):
    """A DeepSeek-V2 MoE block whose experts run on a GlweExpertsExecutor.

    The router runs on the client in the clear as the block's gate states
    it: softmax scores, greedy top-k, no renormalisation unless
    `norm_topk_prob`, times `routed_scaling_factor`. Only the routed experts
    in `held` (default: all) run here, so blocks holding disjoint experts
    add up to the whole layer; the block's shared experts, if it has any,
    run on every token, split into experts of the routed width. The output
    is the weighted sum of the pairs' expert outputs, in x's device and
    dtype."""

    def __init__(self, block, held=None, params=None, n_bits: int = 8):
        super().__init__()
        gate = block.gate
        self.router = gate.weight.detach().cpu().float()  # (experts, C)
        self.top_k, self.norm_topk_prob = gate.top_k, gate.norm_topk_prob
        self.scaling = float(gate.routed_scaling_factor)
        if getattr(gate, "scoring_func", "softmax") != "softmax" or getattr(gate, "topk_method", "greedy") != "greedy":
            raise NotImplementedError("FheMoEModule routes by softmax scores and greedy top-k")
        self.held = tuple(range(len(block.experts))) if held is None else tuple(held)
        mlps = [block.experts[e] for e in self.held]
        gates, ups, downs = ([_weight(m.gate_proj) for m in mlps], [_weight(m.up_proj) for m in mlps],
                             [_weight(m.down_proj) for m in mlps])
        if getattr(block, "shared_experts", None) is not None:
            s, width = block.shared_experts, block.experts[0].gate_proj.out_features
            for lo in range(0, s.gate_proj.out_features, width):
                gates.append(_weight(s.gate_proj)[:, lo:lo + width])
                ups.append(_weight(s.up_proj)[:, lo:lo + width])
                downs.append(_weight(s.down_proj)[lo:lo + width])
        self.executor = GlweExpertsExecutor(gate=gates, up=ups, down=downs, held=self.held, n_bits_in=n_bits,
                                            n_bits_w=n_bits, params=params)
        self.fhe = FheMode.DISABLE

    def route(self, x: np.ndarray) -> tuple:
        """x (T, C) -> the top-k experts (T, k) and their weights (T, k),
        scored in float32 as the block's gate scores them."""
        scores = (torch.from_numpy(x).float() @ self.router.T).softmax(dim=-1)
        w, idx = torch.topk(scores, self.top_k, dim=-1)
        if self.top_k > 1 and self.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            w = w * self.scaling
        return idx.numpy(), w.double().numpy()

    def forward(self, x):
        xp = x.detach().cpu().numpy().astype(np.float64)
        flat = xp.reshape(-1, xp.shape[-1])
        idx, w = self.route(flat)
        local = {e: i for i, e in enumerate(self.held)}
        tok, slot = np.nonzero(np.isin(idx, self.held))
        experts = np.array([local[e] for e in idx[tok, slot]], dtype=np.int64)
        weights = w[tok, slot]
        n_shared = self.executor.n_shared
        if n_shared:
            every = np.arange(len(flat))
            tok = np.concatenate([tok, np.repeat(every, n_shared)])
            experts = np.concatenate([experts, np.tile(len(self.held) + np.arange(n_shared), len(flat))])
            weights = np.concatenate([weights, np.ones(len(flat) * n_shared)])
        y = np.zeros_like(flat)
        if len(tok):
            out = self.executor.forward(flat, tok, experts, fhe=self.fhe)
            np.add.at(y, tok, out * weights[:, None])
        return _like(y.reshape(xp.shape), x)


class RemoteLinearModule(torch.nn.Module):
    """An nn.Linear executed remotely by a RemoteModule."""

    def __init__(self, remote: RemoteModule):
        super().__init__()
        self._remote = remote

    def forward(self, x):
        return _like(self._remote.forward(x.detach().cpu().numpy()), x)


class HybridFHEModel:
    """Wraps a torch module; `module_names` linear layers run under FHE, and
    so do the shared experts and the routed experts this server holds,
    `held` (keyword-only; default all), of each MoE block in `moe_blocks`
    (keyword-only)."""

    def __init__(self, model, module_names: Iterable[str], params=None, n_bits: int = 8, *,
                 moe_blocks: Iterable[str] = (), held=None):
        self.model = model
        self.module_names = list(module_names)
        self._fhe_layers: dict[str, torch.nn.Module] = {}
        for name in self.module_names:
            parent, attr, lin = _linear_at(model, name)
            layer = FheLinearModule(linear_executor(lin, params, n_bits))
            self._fhe_layers[name] = layer
            setattr(parent, attr, layer)
        for name in moe_blocks:
            parent, attr = _locate(model, name)
            layer = FheMoEModule(getattr(parent, attr), held, params=params, n_bits=n_bits)
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

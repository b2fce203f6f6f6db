"""FHE-offloaded LoRA fine-tuning (counterpart of tfhe_tpu/ml/lora.py).

Analog of the reference's LoRA stack (reference:
ml/concrete-ml/src/concrete/ml/torch/lora.py LoraTraining :95 /
LoraTrainer :330, hybrid_backprop_linear.py): the frozen base linear
layers run under FHE through GlweLinearLayerExecutor (their weights never
leave the server in a deployment), while the low-rank adapters A/B train
locally in torch. The backward pass through the frozen base uses the clear
linear transpose -- the trick of hybrid_backprop_linear.py: forward
encrypted, backward a plain product, so no PBS and no kernel in the
backward graph.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.hybrid import _like, _linear_at
from tfhe_tpu_torch.ml.hybrid_server import linear_executor


class _FheBaseFn(torch.autograd.Function):
    """Forward through the encrypted executor; backward through the clear
    transpose (reference hybrid_backprop_linear.py)."""

    @staticmethod
    def forward(ctx, x, executor, w, fhe_mode):
        ctx.w = w  # (in, out) float, the clear weights of the backward
        xp = x.detach().cpu().numpy().astype(np.float64)
        y = executor.forward(xp.reshape(-1, xp.shape[-1]), fhe=fhe_mode)
        return _like(y.reshape(*xp.shape[:-1], y.shape[-1]), x)

    @staticmethod
    def backward(ctx, gy):
        return gy @ ctx.w.T.to(device=gy.device, dtype=gy.dtype), None, None, None


class LoraLinear(torch.nn.Module):
    """A frozen nn.Linear run under FHE plus trainable adapters:
    y = base(x) + lora_b(lora_a(x)) * alpha / rank."""

    def __init__(self, base_linear: torch.nn.Linear, rank: int, alpha: float, n_bits: int, params):
        super().__init__()
        self.executor = linear_executor(base_linear, params, n_bits)
        w = self.executor.weights
        self.w = torch.from_numpy(np.ascontiguousarray(w)).float()  # for backward
        in_f, out_f = w.shape
        # the JAX package's order of draws from torch's global RNG
        self.lora_a = torch.nn.Linear(in_f, rank, bias=False)
        self.lora_b = torch.nn.Linear(rank, out_f, bias=False)
        torch.nn.init.normal_(self.lora_a.weight, std=1.0 / rank)
        torch.nn.init.zeros_(self.lora_b.weight)
        self.scaling = alpha / rank
        self.fhe = FheMode.DISABLE

    def forward(self, x):
        base = _FheBaseFn.apply(x, self.executor, self.w, self.fhe)
        return base + self.lora_b(self.lora_a(x)) * self.scaling


class LoraTraining:
    """Wrap a torch model for LoRA training with FHE base layers
    (reference lora.py LoraTraining). `target_modules`: dotted names of
    nn.Linear layers to adapt (all Linears if None)."""

    def __init__(
        self,
        model,
        rank: int = 4,
        alpha: float = 8.0,
        target_modules: Iterable[str] | None = None,
        n_bits: int = 8,
        params=None,
    ):
        self.model = model
        self._lora_layers: dict[str, LoraLinear] = {}
        names = (
            list(target_modules)
            if target_modules is not None
            else [n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)]
        )
        for name in names:
            parent, attr, lin = _linear_at(model, name)
            layer = LoraLinear(lin, rank, alpha, n_bits, params)
            setattr(parent, attr, layer)
            self._lora_layers[name] = layer
        # freeze everything except adapters
        for p in model.parameters():
            p.requires_grad_(False)
        for layer in self._lora_layers.values():
            layer.lora_a.weight.requires_grad_(True)
            layer.lora_b.weight.requires_grad_(True)

    def compile(self, seed: int = 0, device=None):
        """Generate keys for every base layer on `device` (default "cuda")."""
        for i, layer in enumerate(self._lora_layers.values()):
            layer.executor.keygen(seed + i, device=device)
        return self

    def set_fhe_mode(self, fhe: FheMode | str):
        fhe = FheMode.from_any(fhe)
        for layer in self._lora_layers.values():
            layer.fhe = fhe

    def trainable_parameters(self):
        for layer in self._lora_layers.values():
            yield layer.lora_a.weight
            yield layer.lora_b.weight

    def __call__(self, x):
        return self.model(x)


class LoraTrainer:
    """The training loop (reference lora.py LoraTrainer :330)."""

    def __init__(self, lora_training: LoraTraining, loss_fn: Callable | None = None, lr: float = 1e-2):
        self.lt = lora_training
        self.loss_fn = loss_fn or torch.nn.MSELoss()
        self.opt = torch.optim.Adam(list(self.lt.trainable_parameters()), lr=lr)

    def train(self, data: Iterable, epochs: int = 1, fhe: FheMode | str = FheMode.DISABLE) -> list:
        """data: iterable of (x, y) torch tensors. Returns per-epoch loss."""
        self.lt.set_fhe_mode(fhe)
        losses = []
        for _ in range(epochs):
            tot, nb = 0.0, 0
            for x, y in data:
                self.opt.zero_grad()
                out = self.lt(x)
                loss = self.loss_fn(out, y)
                loss.backward()
                self.opt.step()
                tot += float(loss.detach())
                nb += 1
            losses.append(tot / max(nb, 1))
        return losses

    def save_adapters(self, path: str):
        torch.save(
            {
                name: {"lora_a": layer.lora_a.weight.detach(), "lora_b": layer.lora_b.weight.detach()}
                for name, layer in self.lt._lora_layers.items()
            },
            path,
        )

"""DeepSeek-V2's MoE block in plain float32 torch, the benchmark's copy of
the MoE part of the repository's plain DeepSeek-V2 layer
(`tests/deepseek_v2_reference.py`; the benchmark imports nothing from the
tests): the softmax router with greedy top-k, no renormalisation
(`norm_topk_prob` false) and the weights times `routed_scaling_factor`;
the routed SiLU-gated experts; the shared experts, one MLP of
`n_shared_experts` times the routed width, on every token. TF32 is off.
Multi-head latent attention, which the MoE cell does not run, is left out
here.

For the MoE cell it also routes a card's share of a layer and gives each
(token, expert) pair's exact integer product: the yardstick of
`generators/moe_closed_loop`. Nothing here imports the measured program.
"""

from __future__ import annotations

import torch
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class MLP(nn.Module):
    """down(SiLU(gate x) * up x), no biases."""

    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, intermediate, bias=False)
        self.up_proj = nn.Linear(hidden, intermediate, bias=False)
        self.down_proj = nn.Linear(intermediate, hidden, bias=False)

    def forward(self, x):
        return self.down_proj(nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, norm_topk_prob: bool = False,
          routed_scaling_factor: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The published router: x (T, C), router weights (experts, C) ->
    experts (T, k) and their weights (T, k), scored in float32."""
    scores = (x.float() @ router.float().T).softmax(dim=-1)
    w, idx = torch.topk(scores, top_k, dim=-1)
    if top_k > 1 and norm_topk_prob:
        return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * routed_scaling_factor


def moe(x: torch.Tensor, router: torch.Tensor, experts: list, shared, top_k: int, norm_topk_prob: bool = False,
        routed_scaling_factor: float = 1.0) -> torch.Tensor:
    """The MoE block's output for x (T, C): each token's top-k experts
    weighted, plus the shared experts (`shared`, an MLP, or None)."""
    idx, w = route(x, router, top_k, norm_topk_prob, routed_scaling_factor)
    y = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for e, we in zip(idx[t].tolist(), w[t]):
            y[t] += we * experts[e](x[t])
    return y if shared is None else y + shared(x)


def held_pairs(x: torch.Tensor, router: torch.Tensor, top_k: int, held: int) -> torch.Tensor:
    """The (token, expert) pairs of x's top-k routing whose expert is one of
    the first `held` (the card's share), token by token: (pairs, 2)."""
    idx, _ = route(x, router, top_k)
    idx, _ = idx.sort(dim=-1)
    tok = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(idx)
    keep = idx < held
    return torch.stack([tok[keep], idx[keep]], dim=1)


def pair_products(x: torch.Tensor, weights: torch.Tensor, rows: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """Exact integer products of each pair: x (R, C) small ints, weights
    (E, C, O) small ints, pair i is row rows[i] through expert experts[i] ->
    (pairs, O) int64. Exact in float64 while |sum| < 2^53."""
    out = torch.empty((len(rows), weights.shape[-1]), dtype=torch.int64, device=x.device)
    for e in experts.unique().tolist():
        sel = (experts == e).nonzero().flatten()
        out[sel] = (x[rows[sel]].to(torch.float64) @ weights[e].to(torch.float64)).to(torch.int64)
    return out

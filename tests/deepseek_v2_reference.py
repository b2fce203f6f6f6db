"""A DeepSeek-V2 decoder layer in plain float32 torch: the yardstick of the
port's MoE path (`tests/test_torch_port_moe.py`). It imports neither JAX
nor any part of either package, and computes in float32 with TF32 off.

It follows the published description (DeepSeek-V2, arXiv:2405.04434, and
the model's `modeling_deepseek.py` as published with
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite): RMSNorm before
attention and before the MLP, each with a residual; multi-head latent
attention (MLA) with the low-rank joint KV compression, the decoupled
rotary key shared across heads, the rope/nope split of queries and keys,
and no query compression (`q_lora_rank` null, as in V2-Lite); the MoE
block's softmax router with greedy top-k, no renormalisation
(`norm_topk_prob` false) and the weights times `routed_scaling_factor`;
the routed SiLU-gated experts and the shared experts, one MLP of
`n_shared_experts` times the routed width, added on every token. Module and
attribute names are the published ones, so a model built here reads as
the published one does.

Departures, each without effect on the MoE block:
- plain RoPE at `rope_theta`, without V2-Lite's YaRN scaling (factor 40)
  and its softmax `mscale`; the softmax scale is (nope + rope head
  size)^-0.5;
- one sequence, no KV cache, no attention mask beyond causality, no
  dropout; the router's auxiliary balance loss (training only) is left
  out;
- the experts run token by token in a loop (the published `moe_infer`
  sorts tokens by expert first: the same sums in another order).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Config:
    """DeepSeek-V2-Lite's published numbers (its `config.json`)."""

    hidden_size: int = 2048
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.eps = eps

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


class MLP(nn.Module):
    """down(SiLU(gate x) * up x), no biases."""

    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, intermediate, bias=False)
        self.up_proj = nn.Linear(hidden, intermediate, bias=False)
        self.down_proj = nn.Linear(intermediate, hidden, bias=False)

    def forward(self, x):
        return self.down_proj(nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class MoEGate(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.top_k = cfg.num_experts_per_tok
        self.norm_topk_prob = cfg.norm_topk_prob
        self.routed_scaling_factor = cfg.routed_scaling_factor
        self.scoring_func, self.topk_method = cfg.scoring_func, cfg.topk_method
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        nn.init.kaiming_uniform_(self.weight, a=5**0.5)

    def forward(self, x):
        """x (T, C) -> experts (T, k) and their weights (T, k)."""
        scores = (x.float() @ self.weight.float().T).softmax(dim=-1)
        w, idx = torch.topk(scores, self.top_k, dim=-1)
        if self.top_k > 1 and self.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            w = w * self.routed_scaling_factor
        return idx, w


class MoE(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.experts = nn.ModuleList(MLP(cfg.hidden_size, cfg.moe_intermediate_size)
                                     for _ in range(cfg.n_routed_experts))
        self.gate = MoEGate(cfg)
        self.shared_experts = MLP(cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)

    def forward(self, x):
        flat = x.reshape(-1, x.shape[-1])
        idx, w = self.gate(flat)
        y = torch.zeros_like(flat)
        for t in range(flat.shape[0]):
            for e, we in zip(idx[t].tolist(), w[t]):
                y[t] += we * self.experts[e](flat[t])
        return (y + self.shared_experts(flat)).reshape(x.shape)


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rope(x, theta: float):
    """x (..., S, d): rotary embedding at positions 0..S-1, on the
    published layout (pairs interleaved, regrouped into halves first)."""
    *lead, s, d = x.shape
    x = x.reshape(*lead, s, d // 2, 2).transpose(-1, -2).reshape(*lead, s, d)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.outer(torch.arange(s, dtype=torch.float32), inv)
    emb = torch.cat([ang, ang], dim=-1)
    return x * emb.cos() + _rotate_half(x) * emb.sin()


class Attention(nn.Module):
    """MLA without query compression."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        h, q_head = cfg.num_attention_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, h * q_head, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(cfg.hidden_size, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, cfg.hidden_size, bias=False)

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h, nope, rope, vd = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q = self.q_proj(x).view(b, s, h, nope + rope).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        ckv, k_pe = self.kv_a_proj_with_mqa(x).split([cfg.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(ckv)).view(b, s, h, nope + vd).transpose(1, 2)
        k_nope, v = kv.split([nope, vd], dim=-1)
        q_pe = apply_rope(q_pe, cfg.rope_theta)
        k_pe = apply_rope(k_pe.view(b, 1, s, rope), cfg.rope_theta).expand(b, h, s, rope)
        query, key = torch.cat([q_nope, q_pe], dim=-1), torch.cat([k_nope, k_pe], dim=-1)
        att = (query @ key.transpose(-1, -2)) * (nope + rope) ** -0.5
        att = att.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf")).softmax(dim=-1)
        return self.o_proj((att @ v).transpose(1, 2).reshape(b, s, h * vd))


class DecoderLayer(nn.Module):
    """One MoE decoder layer: x + attn(norm x), then + moe(norm x)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoE(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

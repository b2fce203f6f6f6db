"""LWE layer: encrypt/decrypt, keyswitch, sample extraction (counterpart of
tfhe_tpu/core/lwe.py). An LWE ciphertext is an int64 tensor (..., n+1):
n mask coefficients followed by the body."""

from __future__ import annotations

import dataclasses

import torch

from tfhe_tpu_torch import _u64
from tfhe_tpu_torch.core.keys import LweSecretKey
from tfhe_tpu_torch.params import GadgetParams, NoiseDistribution
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import signed_decompose


def encrypt_lwe(sk: LweSecretKey, pt, rng: FheRng, noise: NoiseDistribution) -> torch.Tensor:
    """pt (...,) torus values -> ct (..., n+1)."""
    pt = torch.as_tensor(pt, device=sk.key.device).to(torch.int64)
    batch = tuple(pt.shape)
    mask = rng.uniform_torus(batch + (sk.n,)).to(pt.device)
    e = rng.noise(noise, batch).to(pt.device)
    body = pt + e + (mask * sk.key).sum(dim=-1)
    return torch.cat([mask, body[..., None]], dim=-1)


def decrypt_lwe(sk: LweSecretKey, ct: torch.Tensor) -> torch.Tensor:
    """Phase: body - <mask, s>."""
    return ct[..., -1] - (ct[..., :-1] * sk.key).sum(dim=-1)


def trivial_lwe(pt: torch.Tensor, n: int) -> torch.Tensor:
    pt = pt.to(torch.int64)
    mask = torch.zeros(tuple(pt.shape) + (n,), dtype=torch.int64, device=pt.device)
    return torch.cat([mask, pt[..., None]], dim=-1)


def lwe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def lwe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def lwe_scalar_mul(a: torch.Tensor, c) -> torch.Tensor:
    """a * c mod 2^64 for an integer constant c (any int, read mod 2^64)."""
    return a * _u64.const(int(c))


def lwe_add_plain(a: torch.Tensor, pt) -> torch.Tensor:
    """Add torus plaintext(s) pt to the body: a new tensor."""
    out = a.clone()
    out[..., -1] += torch.as_tensor(pt, device=a.device).to(torch.int64)
    return out


def sample_extract(glwe_ct: torch.Tensor, index: int = 0) -> torch.Tensor:
    """Coefficient `index` of a GLWE ciphertext as an LWE ciphertext under
    the flattened key: (..., k+1, N) -> (..., k*N + 1). For key poly j,
    a'_{jN+i} = mask_j[index-i] for i <= index, -mask_j[N+index-i] above."""
    n = glwe_ct.shape[-1]
    k = glwe_ct.shape[-2] - 1
    mask = glwe_ct[..., :-1, :]
    body = glwe_ct[..., -1, index]
    i = torch.arange(n, device=glwe_ct.device)
    src = (index - i) % n
    extracted = mask[..., src]
    extracted = torch.where(i > index, -extracted, extracted)
    flat = extracted.reshape(*glwe_ct.shape[:-2], k * n)
    return torch.cat([flat, body[..., None]], dim=-1)


def sample_extract_all(glwe_ct: torch.Tensor) -> torch.Tensor:
    """All N coefficients at once, by one gather over index tensors:
    (..., k+1, N) -> (..., N, k*N+1); row t is sample_extract(glwe_ct, t)."""
    n = glwe_ct.shape[-1]
    k = glwe_ct.shape[-2] - 1
    mask = glwe_ct[..., :-1, :]
    body = glwe_ct[..., -1, :]  # (..., N)
    i = torch.arange(n, device=glwe_ct.device)
    t = i[:, None]  # extraction index
    src = (t - i[None, :]) % n  # (N_t, N_i)
    ext = mask[..., src.reshape(-1)].reshape(*mask.shape[:-1], n, n)  # (..., k, N_t, N_i)
    ext = torch.where(i[None, :] > t, -ext, ext)
    flat = ext.movedim(-3, -2).reshape(*glwe_ct.shape[:-2], n, k * n)
    return torch.cat([flat, body[..., None]], dim=-1)


@dataclasses.dataclass
class KeyswitchKey:
    """LWE -> LWE keyswitch key.

    ksk: (n_in, level, n_out+1) int64; ksk[i, l] encrypts
    s_in[i] * q / B^(l+1) under s_out.
    ksk_limbs: (16, n_in*level, n_out+1) int8, the key in sixteen 4-bit
    limbs, LSB first (the JAX package's layout)."""

    ksk: torch.Tensor
    ksk_limbs: torch.Tensor
    gadget: GadgetParams
    _rhs: torch.Tensor | None = dataclasses.field(default=None, repr=False)

    @property
    def n_in(self) -> int:
        return self.ksk.shape[0]

    @property
    def n_out(self) -> int:
        return self.ksk.shape[2] - 1

    def matmul_rhs(self) -> torch.Tensor:
        """The limbs as one (n_in*level, 16*W) matrix for the keyswitch
        product: int8 with W = n_out+1 padded to a multiple of 8 on CUDA
        (torch._int_mm's shape rule), int32 with W = n_out+1 on the CPU."""
        if self._rhs is None:
            limbs = self.ksk_limbs
            w = limbs.shape[-1]
            if limbs.is_cuda:
                limbs = torch.nn.functional.pad(limbs, (0, (-w) % 8))
            else:
                limbs = limbs.to(torch.int32)
            self._rhs = limbs.permute(1, 0, 2).reshape(limbs.shape[1], -1).contiguous()
        return self._rhs


def _u64_to_nibbles(x: torch.Tensor) -> torch.Tensor:
    """(..., m) -> int8 (16, ..., m) 4-bit limbs, LSB first."""
    return torch.stack([(_u64.srl(x, 4 * l) & 0xF).to(torch.int8) for l in range(16)], dim=0)


def gen_keyswitch_key(
    sk_in: LweSecretKey,
    sk_out: LweSecretKey,
    gadget: GadgetParams,
    rng: FheRng,
    noise: NoiseDistribution,
) -> KeyswitchKey:
    b, l = gadget.base_log, gadget.level
    if b > 7:
        raise ValueError("keyswitch digits must fit int8")
    shifts = torch.tensor([64 - (i + 1) * b for i in range(l)], device=sk_in.key.device)
    pts = sk_in.key[:, None] << shifts[None, :]
    ksk = encrypt_lwe(sk_out, pts, rng, noise)
    flat = ksk.reshape(sk_in.n * l, -1)
    return KeyswitchKey(ksk=ksk, ksk_limbs=_u64_to_nibbles(flat), gadget=gadget)


def keyswitch(ct: torch.Tensor, ksk: KeyswitchKey) -> torch.Tensor:
    """(..., n_in+1) -> (..., n_out+1) under the output key:
    (0, body) - sum_{i,l} digit_{i,l} * ksk[i,l], with the contraction as
    one integer product of the digits against the 16 key limbs
    (|digit| * 15 * n_in * level < 2^31, so int32 sums are exact), then
    recombined with wrapping shifts. On CUDA the product is
    torch._int_mm (int8 x int8 -> int32); on the CPU an int32 matmul
    (an int8 matmul there would wrap in int8)."""
    batch = ct.shape[:-1]
    digits = signed_decompose(ct[..., :-1], ksk.gadget)  # (..., n_in, level)
    flat = digits.reshape(-1, digits.shape[-2] * digits.shape[-1])
    m = flat.shape[0]
    w = ksk.n_out + 1
    rhs = ksk.matmul_rhs()
    if ct.is_cuda:
        mp = max(32, m + (-m) % 8)
        lhs = torch.zeros((mp, flat.shape[1]), dtype=torch.int8, device=ct.device)
        lhs[:m] = flat.to(torch.int8)
        part = torch._int_mm(lhs, rhs)[:m]
    else:
        part = flat.to(torch.int32) @ rhs
    part = part.reshape(m, 16, -1)[..., :w].to(torch.int64)
    acc = part[:, 0]
    for l in range(1, 16):
        acc = acc + (part[:, l] << (4 * l))
    out = (-acc).reshape(*batch, w)
    out[..., -1] += ct[..., -1]
    return out

"""GLWE encrypted-vector x clear-matrix multiplication (counterpart of
tfhe_tpu/models/glwe_matmul.py, the backend of concrete-ml's GLWE linear
layers).

  * an input row v (length C) packs into ceil(C/N) GLWE polynomials at
    delta = 2^(64 - bits_reserved_for_computation);
  * dot(v, w) is a negacyclic product against reverse(w) per chunk: the
    wrap-free coefficient N-1 holds the chunk's dot product;
  * one-to-many: the ciphertexts are forward-transformed once and
    multiplied against every output column in the transform domain, the
    products summed over chunks (plain tensor code, as in JAX);
  * the mask polynomials go through the full inverse (K2 on the card), the
    body's coefficient N-1 through one dot against a fixed inverse row
    (FoldedCrtEngine.backward_coeff); sample extraction at N-1 reverses
    each mask polynomial;
  * the O LWEs of a row pack back into ceil(O/N) GLWEs under the post key
    (core/packing), then switch to the 2^ct_modulus_out_bits storage
    modulus.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tfhe_tpu_torch import _device, _u64
from tfhe_tpu_torch.core.glwe import decrypt_glwe, encrypt_glwe
from tfhe_tpu_torch.core.keys import GlweSecretKey, gen_glwe_secret_key, glwe_to_lwe_secret_key
from tfhe_tpu_torch.core.packing import PackingKeyswitchKey, gen_packing_keyswitch_key, packing_keyswitch
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from tfhe_tpu_torch.params import PARAMS_8B_2048, MatmulParams
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import mod_switch


@dataclasses.dataclass
class MatmulPrivateKey:
    """Input GLWE key, post-compression GLWE key and the packing
    keyswitch key between them."""

    glwe_key: GlweSecretKey
    post_key: GlweSecretKey
    pksk: PackingKeyswitchKey
    params: MatmulParams

    @property
    def device(self) -> torch.device:
        return self.glwe_key.key.device


@dataclasses.dataclass
class EncryptedMatrix:
    """glwes: (R, n_chunks, k+1, N); row r packed into chunk polynomials."""

    glwes: torch.Tensor
    params: MatmulParams
    n_valid: int  # C, the true inner dimension
    shape: tuple


@dataclasses.dataclass
class CompressedResultMatrix:
    """Packed and modulus-switched result: (R, n_out_chunks, k+1, N) int32
    bit patterns of u32 values below 2^n_bits_out."""

    data: torch.Tensor
    params: MatmulParams
    shape: tuple  # (R, O)
    n_bits_out: int


@dataclasses.dataclass
class PreparedClearMatrix:
    """The clear operand in the transform domain with Shoup companions,
    built once by prepare_clear_weights: f_w (O, n_chunks, P, 2, N) int32."""

    f_w: torch.Tensor
    params: MatmulParams
    shape: tuple  # (C, O)


def default_params() -> MatmulParams:
    return PARAMS_8B_2048


def create_private_key(params: MatmulParams, seed: int = 0, device=None) -> MatmulPrivateKey:
    """Keys on `device` (default "cuda"). Draw order: input key, post key,
    packing keyswitch key."""
    dev = _device.resolve(device)
    rng = FheRng(seed, dev)
    engine = get_folded_engine(params.polynomial_size, device=dev)
    glwe_key = gen_glwe_secret_key(rng, params.glwe_dimension, params.polynomial_size)
    post_key = gen_glwe_secret_key(rng, params.glwe_dimension, params.polynomial_size)
    pksk = gen_packing_keyswitch_key(
        glwe_to_lwe_secret_key(glwe_key), post_key, params.packing_ks, rng, params.packing_ks_noise, engine
    )
    return MatmulPrivateKey(glwe_key=glwe_key, post_key=post_key, pksk=pksk, params=params)


def _delta(params: MatmulParams) -> int:
    return 1 << (64 - params.bits_reserved_for_computation)


def _as_u64_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return _u64.u64_from_numpy(np.asarray(x).astype(np.uint64)).to(device)


def encrypt_matrix(pkey: MatmulPrivateKey, matrix, rng: FheRng | None = None, seed: int = 1) -> EncryptedMatrix:
    """matrix (R, C) of unsigned ints below 2^bits -> encrypted rows on the
    key's device."""
    p = pkey.params
    n = p.polynomial_size
    dev = pkey.device
    if rng is None:
        rng = FheRng(seed, dev)
    engine = get_folded_engine(n, device=dev)
    m = _as_u64_tensor(matrix, dev)
    r, c = m.shape
    n_chunks = -(-c // n)
    padded = torch.nn.functional.pad(m, (0, n_chunks * n - c))
    pts = padded.reshape(r, n_chunks, n) * _delta(p)
    glwes = encrypt_glwe(pkey.glwe_key, pts, rng, p.glwe_noise, engine)
    return EncryptedMatrix(glwes=glwes, params=p, n_valid=c, shape=(r, c))


def prepare_clear_weights(
    params: MatmulParams, clear, n_valid: int | None = None, *, device=None
) -> PreparedClearMatrix:
    """Forward-transform a clear weight matrix (C, O) of small signed ints
    once, on `device` (keyword-only, default "cuda"). Checks the CRT
    reconstruction bound: each output coefficient sums n_chunks products
    of full-width ciphertext words with the weights. `n_valid` is accepted
    and unused, as in the JAX package."""
    n = params.polynomial_size
    engine = get_folded_engine(n, device=device)
    w = clear.detach().cpu().numpy() if isinstance(clear, torch.Tensor) else np.asarray(clear)
    c, o = w.shape
    n_chunks = -(-c // n)
    w_bits = engine.max_product_bits - 64 - max(0, math.ceil(math.log2(n_chunks)))
    if np.abs(w.astype(np.int64)).max(initial=0) >= (1 << w_bits):
        raise ValueError(
            f"prepare_clear_weights: |clear| entries must be < 2^{w_bits} "
            "at these parameters (CRT reconstruction range)"
        )
    wt = torch.from_numpy(w.astype(np.int64)).to(engine.device)
    pad = torch.nn.functional.pad(wt, (0, 0, 0, n_chunks * n - c))
    w_rev = pad.reshape(n_chunks, n, o).flip(1)  # each chunk reversed
    w_polys = w_rev.movedim(-1, 0)  # (O, n_chunks, N)
    f_w = engine.make_shoup(engine.forward_small(w_polys))
    return PreparedClearMatrix(f_w=f_w, params=params, shape=(c, o))


def matrix_multiplication(enc: EncryptedMatrix, clear, pkey: MatmulPrivateKey) -> CompressedResultMatrix:
    """enc (R, C) x clear (C, O) -> compressed encrypted result (R, O).
    clear: a small signed int matrix or a PreparedClearMatrix."""
    engine = get_folded_engine(enc.params.polynomial_size, device=enc.glwes.device)
    if not isinstance(clear, PreparedClearMatrix):
        clear = prepare_clear_weights(enc.params, clear, device=enc.glwes.device)
    return _matmul_prepared(enc, clear, pkey, engine)


def _matmul_prepared(
    enc: EncryptedMatrix, prep: PreparedClearMatrix, pkey: MatmulPrivateKey, engine
) -> CompressedResultMatrix:
    p = enc.params
    n = p.polynomial_size
    c, o = prep.shape
    if c != enc.n_valid:
        raise ValueError(f"inner dimensions differ: {enc.n_valid} encrypted, {c} clear")
    r = enc.shape[0]
    # one-to-many: every ciphertext transformed once (K1), the weights are
    # the fixed operand with the Shoup companions
    f_ct = engine.forward_u64(enc.glwes)  # (R, chunks, k+1, P, N)
    prod = engine.pointwise_shoup(f_ct[:, None], prep.f_w[None, :, :, None])  # (R, O, chunks, k+1, P, N)
    f = engine.reduce_u64_domain(prod.to(torch.int64).sum(dim=2))  # (R, O, k+1, P, N)
    # the masks need every coefficient (the packing keyswitch decomposes
    # them all); the body only its coefficient N-1
    mask_coeffs = engine.backward(f[..., :-1, :, :])  # (R, O, k, N)
    body_n1 = engine.backward_coeff(f[..., -1, :, :], n - 1)  # (R, O)
    # sample extraction at N-1: src = N-1-i never wraps, so the extracted
    # mask is each key polynomial reversed, with no negation
    k_dim = mask_coeffs.shape[-2]
    ext = mask_coeffs.flip(-1)
    lwes = torch.cat([ext.reshape(r, o, k_dim * n), body_n1[..., None]], dim=-1)  # (R, O, kN+1)
    # pack each row's O LWEs into ceil(O/N) GLWEs under the post key
    n_out_chunks = -(-o // n)
    lwes = torch.nn.functional.pad(lwes, (0, 0, 0, n_out_chunks * n - o))
    packed = packing_keyswitch(lwes.reshape(r, n_out_chunks, n, -1), pkey.pksk, engine)
    stored = _u64.to_i32(mod_switch(packed, p.ct_modulus_out_bits))
    return CompressedResultMatrix(data=stored, params=p, shape=(r, o), n_bits_out=p.ct_modulus_out_bits)


def decrypt_matrix(result: CompressedResultMatrix, pkey: MatmulPrivateKey) -> torch.Tensor:
    """Decrypt to signed int64 (R, O) (negative with signed weights)."""
    p = result.params
    engine = get_folded_engine(p.polynomial_size, device=result.data.device)
    r, o = result.shape
    ct = _u64.u32(result.data) << (64 - result.n_bits_out)  # back to q = 2^64
    phase = decrypt_glwe(pkey.post_key, ct, engine).reshape(r, -1)[:, :o]
    log_delta = 64 - p.bits_reserved_for_computation
    space = 1 << p.bits_reserved_for_computation
    # unsigned (phase + delta/2) // delta mod space
    vals = _u64.srl(phase + (1 << (log_delta - 1)), log_delta) & (space - 1)
    return vals - torch.where(vals >= space // 2, space, 0)

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
    modulus;
  * routed experts (`expert_matmul`, the port's own): rows reach several
    matrices of one shape through a clear table of (row, expert) pairs,
    each row transformed once, the pairs in slices of bounded workspace,
    one packing keyswitch a slice.
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
from tfhe_tpu_torch.utils.profiling import span


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
    # all rows in one pass, the workspace unbounded: in `expert_matmul`'s
    # 16 GiB slices a Llama-3.2-1B block's 8-row gate, up and down
    # projections run 2 rows a slice, 4.5 % slower on an H100 (PERF.md)
    p = enc.params
    c, o = prep.shape
    if c != enc.n_valid:
        raise ValueError(f"inner dimensions differ: {enc.n_valid} encrypted, {c} clear")
    r = enc.shape[0]
    # one-to-many: every ciphertext transformed once (K1), the weights are
    # the fixed operand with the Shoup companions
    f_ct = engine.forward_u64(enc.glwes)  # (R, chunks, k+1, P, N)
    lwes = _extract(_products(engine, f_ct[:, None], prep.f_w), engine)
    stored = _pack(lwes, pkey, engine, p)
    return CompressedResultMatrix(data=stored, params=p, shape=(r, o), n_bits_out=p.ct_modulus_out_bits)


def _products(engine, f_ct: torch.Tensor, f_w: torch.Tensor) -> torch.Tensor:
    """Transformed rows (R, 1, chunks, k+1, P, N) times one prepared
    matrix's f_w (O, chunks, P, 2, N), summed over the chunks: (R, O, k+1,
    P, N)."""
    prod = engine.pointwise_shoup(f_ct, f_w[None, :, :, None])  # (R, O, chunks, k+1, P, N)
    return engine.reduce_u64_domain(prod.to(torch.int64).sum(dim=2))


def _extract(f: torch.Tensor, engine) -> torch.Tensor:
    """Transform-domain products (R, O, k+1, P, N) -> the LWEs of their
    coefficient N-1 (R, O, kN+1)."""
    r, o, _, _, n = f.shape
    # the masks need every coefficient (the packing keyswitch decomposes
    # them all); the body only its coefficient N-1
    mask_coeffs = engine.backward(f[..., :-1, :, :])  # (R, O, k, N)
    body_n1 = engine.backward_coeff(f[..., -1, :, :], n - 1)  # (R, O)
    # sample extraction at N-1: src = N-1-i never wraps, so the extracted
    # mask is each key polynomial reversed, with no negation
    k_dim = mask_coeffs.shape[-2]
    ext = mask_coeffs.flip(-1)
    return torch.cat([ext.reshape(r, o, k_dim * n), body_n1[..., None]], dim=-1)


def _pack(lwes: torch.Tensor, pkey: MatmulPrivateKey, engine, p: MatmulParams) -> torch.Tensor:
    """Each row's O LWEs (R, O, kN+1) packed into ceil(O/N) GLWEs under the
    post key and switched to p's storage modulus: (R, ceil(O/N), k+1, N)
    int32."""
    n = p.polynomial_size
    r, o, _ = lwes.shape
    n_out_chunks = -(-o // n)
    lwes = torch.nn.functional.pad(lwes, (0, 0, 0, n_out_chunks * n - o))
    packed = packing_keyswitch(lwes.reshape(r, n_out_chunks, n, -1), pkey.pksk, engine)
    return _u64.to_i32(mod_switch(packed, p.ct_modulus_out_bits))


# -- routed experts -------------------------------------------------------------

WORKSPACE_BYTES = 16 << 30  # expert_matmul's bound on a slice's workspace
PRODUCT_WORD_BYTES = 64  # workspace a transform-domain word of the one-to-many product takes at its peak


def pair_bytes(prep: PreparedClearMatrix, engine) -> int:
    """The workspace one (row, expert) pair takes in `expert_matmul`: the
    one-to-many product over its chunks at its peak, the largest step."""
    c, o = prep.shape
    n = prep.params.polynomial_size
    k1 = prep.params.glwe_dimension + 1
    return o * -(-c // n) * k1 * engine.n_primes * n * PRODUCT_WORD_BYTES


@span("expert.route")
def _route(routing, n_rows: int, n_experts: int, per_slice: int) -> tuple:
    """The clear routing table (pairs, 2) of (row, expert) -> the rows to
    transform, and the pairs grouped by expert in slices of at most
    `per_slice`: for each slice its range of the grouped order and its
    runs (expert, start, end) of one expert."""
    table = torch.as_tensor(routing, dtype=torch.int64, device="cpu").reshape(-1, 2)
    rows, which = table[:, 0], table[:, 1]
    if len(table) and not (0 <= int(rows.min()) and int(rows.max()) < n_rows):
        raise ValueError(f"routing names a row outside the {n_rows} encrypted rows")
    if len(table) and not (0 <= int(which.min()) and int(which.max()) < n_experts):
        raise ValueError(f"routing names an expert outside the {n_experts} held")
    order = torch.argsort(which, stable=True)  # each expert's pairs in the routing's order
    used, row_of = torch.unique(rows, return_inverse=True)  # each routed row once
    grouped = which[order].tolist()
    slices = []
    for lo in range(0, len(grouped), per_slice):
        hi = min(lo + per_slice, len(grouped))
        runs, start = [], lo
        for i in range(lo + 1, hi + 1):
            if i == hi or grouped[i] != grouped[start]:
                runs.append((grouped[start], start - lo, i - lo))
                start = i
        slices.append((lo, hi, runs))
    return used, row_of[order], torch.argsort(order), slices


def expert_matmul(enc: EncryptedMatrix, experts, routing, pkey: MatmulPrivateKey) -> CompressedResultMatrix:
    """Routed, grouped encrypted x clear matmul: the rows of `enc` (R, C)
    reach the held experts' prepared matrices `experts` (each (C, O), all of
    one shape) through the clear `routing` table of (row, expert index)
    pairs. Returns one compressed result row per pair, (pairs, O), in the
    routing's order; each bit-identical to `matrix_multiplication` of that
    expert on its rows, however the pairs are sliced.

    Each routed row is transformed once (K1), however many of its experts
    are held; an expert with no pairs costs nothing. The pairs, grouped by
    expert, run in slices whose workspace (`pair_bytes` each) stays under
    WORKSPACE_BYTES whatever the loads; a slice's products are extracted
    together and packed under one packing keyswitch."""
    p = enc.params
    n = p.polynomial_size
    experts = list(experts)
    if not experts or any(e.shape != experts[0].shape for e in experts):
        raise ValueError("expert_matmul takes one or more prepared matrices of one shape")
    c, o = experts[0].shape
    if c != enc.n_valid:
        raise ValueError(f"inner dimensions differ: {enc.n_valid} encrypted, {c} clear")
    dev = enc.glwes.device
    engine = get_folded_engine(n, device=dev)
    per_slice = max(1, WORKSPACE_BYTES // pair_bytes(experts[0], engine))
    used, rows, back, slices = _route(routing, enc.shape[0], len(experts), per_slice)
    n_pairs = len(back)
    out = torch.empty((n_pairs, -(-o // n), p.glwe_dimension + 1, n), dtype=torch.int32, device=dev)
    if n_pairs:
        # the gather indices in one copy to the card a call
        used, rows, back = torch.cat([used, rows, back]).to(dev).split([len(used), n_pairs, n_pairs])
        with span("expert.products"):
            f_ct = engine.forward_u64(enc.glwes[used])[:, None]  # (rows, 1, chunks, k+1, P, N)
        for lo, hi, runs in slices:
            with span("expert.products"):
                seg = rows[lo:hi]
                f = torch.cat([_products(engine, f_ct[seg[a:b]], experts[e].f_w) for e, a, b in runs])
                lwes = _extract(f, engine)
                del f  # before the keyswitch's workspace
            with span("expert.keyswitch"):
                out[lo:hi] = _pack(lwes, pkey, engine, p)
        out = out[back]
    expert_matmul.calls += 1
    expert_matmul.pairs += n_pairs
    expert_matmul.slices += len(slices)
    return CompressedResultMatrix(data=out, params=p, shape=(n_pairs, o), n_bits_out=p.ct_modulus_out_bits)


expert_matmul.calls = 0  # grouped calls
expert_matmul.pairs = 0  # (row, expert) pairs over all calls
expert_matmul.slices = 0  # slices over all calls, each one packing keyswitch


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

"""Shortint: the PBS-refreshed small-integer block, over classic or
multi-bit keys (counterpart of tfhe_tpu/models/shortint.py).

Ciphertexts live under the big (extracted) key; each programmable
bootstrap keyswitches down to the small key, blind-rotates and extracts
back up. Every ciphertext tracks a host-side `degree` (the largest value
it can hold), with the same bookkeeping as the JAX package. A Ciphertext
is a batch: `ct` is (..., kN+1) and every op maps over the leading dims.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from tfhe_tpu_torch import _device
from tfhe_tpu_torch.core.bootstrap import BootstrapKey, gen_bootstrap_key, keyswitch_pbs
from tfhe_tpu_torch.core.glwe import trivial_glwe
from tfhe_tpu_torch.core.keys import (
    GlweSecretKey,
    LweSecretKey,
    gen_glwe_secret_key,
    gen_lwe_secret_key,
    glwe_to_lwe_secret_key,
)
from tfhe_tpu_torch.core.lwe import (
    KeyswitchKey,
    decrypt_lwe,
    encrypt_lwe,
    gen_keyswitch_key,
    trivial_lwe,
)
from tfhe_tpu_torch.core.multibit import (
    MultiBitBootstrapKey,
    gen_multibit_bootstrap_key,
    multibit_keyswitch_pbs,
)
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from tfhe_tpu_torch.params import ShortintParams
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import decode, encode


@dataclasses.dataclass
class ClientKey:
    glwe_key: GlweSecretKey
    lwe_key: LweSecretKey  # small key
    params: ShortintParams

    @property
    def big_lwe_key(self) -> LweSecretKey:
        return glwe_to_lwe_secret_key(self.glwe_key)

    @property
    def device(self) -> torch.device:
        return self.glwe_key.key.device


@dataclasses.dataclass
class ServerKey:
    bsk: Union[BootstrapKey, MultiBitBootstrapKey]
    ksk: KeyswitchKey
    params: ShortintParams

    @property
    def device(self) -> torch.device:
        return self.bsk.bsk_ntt.device


@dataclasses.dataclass
class Ciphertext:
    """Batched shortint ciphertext under the big key: ct (..., kN+1)."""

    ct: torch.Tensor
    params: ShortintParams
    degree: int
    noise_level: int

    @property
    def shape(self):
        return self.ct.shape[:-1]


def multibit_group_of(params: ShortintParams) -> int | None:
    """The group size a MULTI_BIT_GROUP_<g>_ parameter-set name implies."""
    if "MULTI_BIT_GROUP_" not in params.name:
        return None
    return int(params.name.split("MULTI_BIT_GROUP_")[1].split("_")[0])


def keygen(
    params: ShortintParams, seed: int = 0, multibit_group: int | None = None, device=None
) -> tuple[ClientKey, ServerKey]:
    """Keys for `params` on `device` (default "cuda"). multibit_group=g
    builds a multi-bit bootstrap key (core/multibit.py) instead of the
    classic one; a MULTI_BIT_GROUP_<g>_ set implies g. apply_lut
    dispatches on the key type. Draw order: GLWE key, small key, BSK, KSK."""
    if multibit_group is None:
        multibit_group = multibit_group_of(params)
    dev = _device.resolve(device)
    engine = get_folded_engine(params.polynomial_size, dev)
    rng = FheRng(seed, dev)
    glwe_sk = gen_glwe_secret_key(rng, params.glwe_dimension, params.polynomial_size)
    small_sk = gen_lwe_secret_key(rng, params.lwe_dimension)
    big_sk = glwe_to_lwe_secret_key(glwe_sk)
    if multibit_group is None:
        bsk = gen_bootstrap_key(small_sk, glwe_sk, params.pbs, rng, params.glwe_noise, engine)
    else:
        bsk = gen_multibit_bootstrap_key(
            small_sk, glwe_sk, params.pbs, multibit_group, rng, params.glwe_noise, engine
        )
    ksk = gen_keyswitch_key(big_sk, small_sk, params.ks, rng, params.lwe_noise)
    return (
        ClientKey(glwe_key=glwe_sk, lwe_key=small_sk, params=params),
        ServerKey(bsk=bsk, ksk=ksk, params=params),
    )


def engine_for(params: ShortintParams, device=None):
    return get_folded_engine(params.polynomial_size, device)


# -- client side --------------------------------------------------------------


def encrypt(ck: ClientKey, values, rng: FheRng) -> Ciphertext:
    """values (...,) ints in [0, message_modulus) -> batched ciphertext."""
    p = ck.params
    values = torch.as_tensor(values, device=ck.device).to(torch.int64)
    ct = encrypt_lwe(ck.big_lwe_key, encode(values, p.delta), rng, p.glwe_noise)
    return Ciphertext(ct=ct, params=p, degree=p.message_modulus - 1, noise_level=1)


def decrypt(ck: ClientKey, c: Ciphertext) -> torch.Tensor:
    """Decode over the whole msg*carry space."""
    p = ck.params
    return decode(decrypt_lwe(ck.big_lwe_key, c.ct), p.delta, p.message_modulus * p.carry_modulus)


def decrypt_message(ck: ClientKey, c: Ciphertext) -> torch.Tensor:
    return decrypt(ck, c) % ck.params.message_modulus


def trivial_encrypt(params: ShortintParams, values, device=None) -> Ciphertext:
    values = torch.as_tensor(values, device=_device.resolve(device)).to(torch.int64)
    ct = trivial_lwe(encode(values, params.delta), params.big_lwe_dimension)
    return Ciphertext(ct=ct, params=params, degree=params.message_modulus - 1, noise_level=0)


# -- lookup tables -------------------------------------------------------------


def generate_lut(params: ShortintParams, f: Union[Callable, np.ndarray], device=None) -> torch.Tensor:
    """Trivial-GLWE accumulator for the PBS of f over [0, msg*carry): each
    value owns a box of N/(msg*carry) coefficients holding f(v)*delta, and
    the polynomial is rotated by half a box so rounding is centered."""
    n = params.polynomial_size
    p_half = params.message_modulus * params.carry_modulus
    box = n // p_half
    if box < 1:
        raise ValueError("polynomial too small for the plaintext space")
    if callable(f):
        table = np.array([int(f(v)) for v in range(p_half)], dtype=np.uint64)
    else:
        table = np.asarray(f, dtype=np.uint64)
        if table.shape != (p_half,):
            raise ValueError(f"LUT table must have {p_half} entries")
    if int(table.max()) >= p_half:
        raise ValueError("LUT output exceeds plaintext space")
    vals = np.repeat(table * np.uint64(params.delta), box)
    neg_head = (-(vals[: box // 2].astype(np.int64))).astype(np.uint64)
    rot = np.concatenate([vals[box // 2 :], neg_head])
    pt = torch.from_numpy(rot.view(np.int64).copy()).to(_device.resolve(device))
    return trivial_glwe(pt, params.glwe_dimension)


def generate_lut_bivariate(params: ShortintParams, f: Callable, device=None) -> torch.Tensor:
    """LUT for f(a, b) evaluated on the packed value a*msg_mod + b."""
    m = params.message_modulus
    p_half = m * params.carry_modulus
    table = np.array([int(f(v // m, v % m)) % p_half for v in range(p_half)], dtype=np.uint64)
    return generate_lut(params, table, device)


# -- server-side operations ----------------------------------------------------


def apply_lut(sk: ServerKey, c: Ciphertext, lut: torch.Tensor, out_degree: int) -> Ciphertext:
    """The PBS atom: keyswitch down + programmable bootstrap with `lut`.
    Dispatches on the key type: multi-bit keys run the n/g-step
    aggregated rotation."""
    p = sk.params
    engine = engine_for(p, sk.device)
    if isinstance(sk.bsk, MultiBitBootstrapKey):
        out = multibit_keyswitch_pbs(c.ct, lut, sk.bsk, sk.ksk, engine)
    else:
        out = keyswitch_pbs(c.ct, lut, sk.bsk, sk.ksk, engine)
    return Ciphertext(ct=out, params=p, degree=out_degree, noise_level=1)


def _check_degree(c: Ciphertext):
    p_half = c.params.message_modulus * c.params.carry_modulus
    if c.degree >= p_half:
        raise ValueError(
            f"degree {c.degree} overflows the {p_half}-value plaintext space; "
            "propagate carries first"
        )


def apply_function(sk: ServerKey, c: Ciphertext, f: Callable) -> Ciphertext:
    p = sk.params
    p_half = p.message_modulus * p.carry_modulus
    _check_degree(c)
    table = [int(f(v)) % p_half for v in range(p_half)]
    out_degree = max(table[: min(c.degree, p_half - 1) + 1])
    lut = generate_lut(p, np.array(table, dtype=np.uint64), sk.device)
    return apply_lut(sk, c, lut, out_degree)


def add(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Unchecked homomorphic add: degrees accumulate into the carry space."""
    if a.params != b.params:
        raise ValueError("ciphertexts of different parameter sets")
    return Ciphertext(
        ct=a.ct + b.ct,
        params=a.params,
        degree=a.degree + b.degree,
        noise_level=a.noise_level + b.noise_level,
    )


def scalar_add(a: Ciphertext, s: int) -> Ciphertext:
    p = a.params
    new = a.ct.clone()
    new[..., -1] += encode(torch.tensor(s), p.delta).item()
    return Ciphertext(ct=new, params=p, degree=a.degree + s, noise_level=a.noise_level)


def scalar_mul(a: Ciphertext, s: int) -> Ciphertext:
    if s < 0:
        raise ValueError("scalar_mul takes s >= 0")
    return Ciphertext(
        ct=a.ct * s, params=a.params, degree=a.degree * s, noise_level=a.noise_level * s
    )


def neg(a: Ciphertext) -> Ciphertext:
    """-x as (z*msg_mod - x) with z = ceil((degree+1)/msg_mod): stays
    non-negative and congruent to -x mod msg_mod."""
    p = a.params
    m = p.message_modulus
    z = -(-(a.degree + 1) // m)
    new = -a.ct
    new[..., -1] += encode(torch.tensor(z * m), p.delta).item()
    return Ciphertext(ct=new, params=p, degree=z * m, noise_level=a.noise_level)


def sub(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    return add(a, neg(b))


def message_extract(sk: ServerKey, a: Ciphertext) -> Ciphertext:
    """PBS(x mod msg_mod): flush carries, refresh noise."""
    m = sk.params.message_modulus
    return apply_function(sk, a, lambda v: v % m)


def carry_extract(sk: ServerKey, a: Ciphertext) -> Ciphertext:
    """PBS(x // msg_mod): the carry as a fresh block."""
    m = sk.params.message_modulus
    return apply_function(sk, a, lambda v: v // m)


def bivariate_pbs(sk: ServerKey, a: Ciphertext, b: Ciphertext, f: Callable) -> Ciphertext:
    """f(a, b) in one PBS via the packing a*msg_mod + b; needs fresh
    operands (degrees below msg_mod)."""
    p = sk.params
    m = p.message_modulus
    p_half = m * p.carry_modulus
    if not (a.degree < m and b.degree < m):
        raise ValueError(f"bivariate PBS needs fresh operands (degrees {a.degree},{b.degree})")
    packed = add(scalar_mul(a, m), b)
    table = [int(f(v // m, v % m)) % p_half for v in range(p_half)]
    out_degree = max(table[x * m + y] for x in range(a.degree + 1) for y in range(b.degree + 1))
    lut = generate_lut(p, np.array(table, dtype=np.uint64), sk.device)
    return apply_lut(sk, packed, lut, out_degree)


def mul(sk: ServerKey, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Block multiply mod the full space via one bivariate PBS."""
    return bivariate_pbs(sk, a, b, lambda x, y: x * y)

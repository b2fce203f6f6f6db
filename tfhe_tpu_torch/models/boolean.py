"""Boolean TFHE: gate bootstrapping over single bits (counterpart of
tfhe_tpu/models/boolean.py).

Bits encode as +-1/8 of the torus. Every binary gate is one linear
combination, one sign-test bootstrap under the big key and a keyswitch back
to the small key: the PBS first and the keyswitch second, the opposite
order of shortint's keyswitch_pbs. Ciphertexts are batched: and_(sk, a, b)
over (B, n+1) tensors is B gate bootstraps in one call. At
BOOLEAN_PARAMS_128 (k=2, PBS level 3) the bootstrap takes the loop of
external products, K1 and K2 once each per rotation step.
"""

from __future__ import annotations

import dataclasses

import torch

from tfhe_tpu_torch import _device
from tfhe_tpu_torch.core.bootstrap import BootstrapKey, gen_bootstrap_key, programmable_bootstrap
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
    keyswitch,
    lwe_add_plain,
)
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from tfhe_tpu_torch.params import BooleanParams
from tfhe_tpu_torch.rng import FheRng

EIGHTH = 1 << 61  # 1/8 of the torus; -EIGHTH is the u64 pattern 2^64 - 2^61


@dataclasses.dataclass
class ClientKey:
    glwe_key: GlweSecretKey
    lwe_key: LweSecretKey  # small key
    params: BooleanParams

    @property
    def device(self) -> torch.device:
        return self.lwe_key.key.device


@dataclasses.dataclass
class ServerKey:
    bsk: BootstrapKey
    ksk: KeyswitchKey  # big -> small, applied after each bootstrap
    params: BooleanParams

    @property
    def device(self) -> torch.device:
        return self.bsk.bsk_ntt.device


def keygen(params: BooleanParams, seed: int = 0, device=None) -> tuple[ClientKey, ServerKey]:
    """Keys on `device` (default "cuda"). Draw order: GLWE key, small key,
    BSK, KSK (big -> small)."""
    dev = _device.resolve(device)
    rng = FheRng(seed, dev)
    engine = get_folded_engine(params.polynomial_size, device=dev)
    glwe_sk = gen_glwe_secret_key(rng, params.glwe_dimension, params.polynomial_size)
    small_sk = gen_lwe_secret_key(rng, params.lwe_dimension)
    big_sk = glwe_to_lwe_secret_key(glwe_sk)
    bsk = gen_bootstrap_key(small_sk, glwe_sk, params.pbs, rng, params.glwe_noise, engine)
    ksk = gen_keyswitch_key(big_sk, small_sk, params.ks, rng, params.lwe_noise)
    return (
        ClientKey(glwe_key=glwe_sk, lwe_key=small_sk, params=params),
        ServerKey(bsk=bsk, ksk=ksk, params=params),
    )


def encrypt(ck: ClientKey, bits, rng: FheRng) -> torch.Tensor:
    """bits (...,) in {0, 1} -> (..., n+1) under the small key; true at
    +1/8, false at -1/8."""
    bits = torch.as_tensor(bits, device=ck.device)
    pt = torch.where(bits != 0, EIGHTH, -EIGHTH)
    return encrypt_lwe(ck.lwe_key, pt, rng, ck.params.lwe_noise)


def decrypt(ck: ClientKey, ct: torch.Tensor) -> torch.Tensor:
    """Sign test: a phase in (0, q/2) is true."""
    return decrypt_lwe(ck.lwe_key, ct) > 0


def _gate_lut(params: BooleanParams, device) -> torch.Tensor:
    """Test polynomial with every coefficient +1/8: blind rotation turns
    it into the sign function."""
    n = params.polynomial_size
    return trivial_glwe(torch.full((n,), EIGHTH, dtype=torch.int64, device=device), params.glwe_dimension)


def _bootstrap(sk: ServerKey, ct: torch.Tensor) -> torch.Tensor:
    engine = get_folded_engine(sk.params.polynomial_size, device=ct.device)
    big = programmable_bootstrap(ct, _gate_lut(sk.params, ct.device), sk.bsk, engine)
    return keyswitch(big, sk.ksk)


def and_(sk: ServerKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bootstrap(sk, lwe_add_plain(a + b, -EIGHTH))


def or_(sk: ServerKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bootstrap(sk, lwe_add_plain(a + b, EIGHTH))


def nand(sk: ServerKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bootstrap(sk, lwe_add_plain(-(a + b), EIGHTH))


def nor(sk: ServerKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bootstrap(sk, lwe_add_plain(-(a + b), -EIGHTH))


def xor_(sk: ServerKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # (a + b) * 2 wraps mod 2^64 like the u64 product; 2 * EIGHTH = 2^62
    return _bootstrap(sk, lwe_add_plain((a + b) * 2, 2 * EIGHTH))


def xnor(sk: ServerKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bootstrap(sk, lwe_add_plain(-(a + b) * 2, -2 * EIGHTH))


def not_(sk: ServerKey, a: torch.Tensor) -> torch.Tensor:
    """Free: torus negation flips the sign encoding. No bootstrap."""
    return -a


def mux(sk: ServerKey, c: torch.Tensor, t: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """c ? t : f: AND(c, t) and AND(!c, f), then a recombining bootstrap."""
    d1 = _bootstrap(sk, lwe_add_plain(c + t, -EIGHTH))
    d2 = _bootstrap(sk, lwe_add_plain(-c + f, -EIGHTH))
    return _bootstrap(sk, lwe_add_plain(d1 + d2, EIGHTH))

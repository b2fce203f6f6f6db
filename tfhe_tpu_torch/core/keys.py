"""Binary secret keys (counterpart of tfhe_tpu/core/keys.py)."""

from __future__ import annotations

import dataclasses

import torch

from tfhe_tpu_torch.rng import FheRng


@dataclasses.dataclass
class GlweSecretKey:
    """Binary GLWE secret: (k, N) int64 in {0, 1}."""

    key: torch.Tensor

    @property
    def k(self) -> int:
        return self.key.shape[0]

    @property
    def n_poly(self) -> int:
        return self.key.shape[1]


@dataclasses.dataclass
class LweSecretKey:
    """Binary LWE secret: (n,) int64 in {0, 1}."""

    key: torch.Tensor

    @property
    def n(self) -> int:
        return self.key.shape[0]


def gen_glwe_secret_key(rng: FheRng, k: int, n_poly: int) -> GlweSecretKey:
    return GlweSecretKey(key=rng.binary((k, n_poly)))


def gen_lwe_secret_key(rng: FheRng, n: int) -> LweSecretKey:
    return LweSecretKey(key=rng.binary((n,)))


def glwe_to_lwe_secret_key(sk: GlweSecretKey) -> LweSecretKey:
    """The key of sample-extracted ciphertexts: the GLWE key polynomials'
    coefficients concatenated."""
    return LweSecretKey(key=sk.key.reshape(-1))


def glwe_key_ntt(sk: GlweSecretKey, engine) -> torch.Tensor:
    """NTT-domain secret with Shoup companions, (k, P, 2, N) int32."""
    return engine.make_shoup(engine.forward_small(sk.key))

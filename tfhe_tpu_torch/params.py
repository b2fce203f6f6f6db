"""Parameter sets of the shortint path, classic and multi-bit.

A copy of the dataclasses and named sets of `tfhe_tpu/params.py` that the
port runs (the port imports nothing of the JAX package). Field names,
values and the canonical-JSON hash are the same, so a parameter set names
the same keys and ciphertext shapes in both packages.

All ciphertext moduli are q = 2^64 (int64 tensors carrying u64 bits).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

Q_BITS = 64


@dataclasses.dataclass(frozen=True)
class NoiseDistribution:
    """Noise sampler spec: "tuniform" (uniform over [-2^b, 2^b], the two
    bounds at half weight), "gaussian" (std as a fraction of q) or
    "zero" (toy sets only)."""

    kind: str
    bound_log2: Optional[int] = None
    std: Optional[float] = None

    def variance_torus(self) -> float:
        if self.kind == "zero":
            return 0.0
        if self.kind == "tuniform":
            b = self.bound_log2
            return (2.0 ** (2 * b + 1) + 1.0) / 6.0
        if self.kind == "gaussian":
            return (self.std * 2.0**Q_BITS) ** 2
        raise ValueError(f"unknown noise kind {self.kind}")

    @staticmethod
    def tuniform(bound_log2: int) -> "NoiseDistribution":
        return NoiseDistribution(kind="tuniform", bound_log2=bound_log2)

    @staticmethod
    def gaussian(std: float) -> "NoiseDistribution":
        return NoiseDistribution(kind="gaussian", std=std)

    @staticmethod
    def zero() -> "NoiseDistribution":
        return NoiseDistribution(kind="zero")


@dataclasses.dataclass(frozen=True)
class GadgetParams:
    """Signed radix decomposition: `level` digits of `base_log` bits of
    the `level * base_log` most significant bits, round-to-closest."""

    base_log: int
    level: int

    def __post_init__(self):
        if self.base_log * self.level > Q_BITS:
            raise ValueError("base_log * level exceeds 64 bits")


@dataclasses.dataclass(frozen=True)
class ShortintParams:
    """Parameters for one shortint block (the PBS unit)."""

    name: str
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise: NoiseDistribution
    glwe_noise: NoiseDistribution
    pbs: GadgetParams
    ks: GadgetParams
    message_modulus: int
    carry_modulus: int

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def plaintext_modulus(self) -> int:
        return 2 * self.message_modulus * self.carry_modulus

    @property
    def delta(self) -> int:
        return 2**Q_BITS // self.plaintext_modulus

    def to_json(self) -> str:
        return json.dumps(
            dataclasses.asdict(self), sort_keys=True, separators=(",", ":")
        )

    @property
    def hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()


# The fhevm default: 2-bit message + 2-bit carry blocks; k=1, N=2048,
# level-1 / base_log-23 PBS, level-5 / base_log-3 keyswitch, TUniform noise.
PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = ShortintParams(
    name="PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
    lwe_dimension=880,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=NoiseDistribution.tuniform(46),
    glwe_noise=NoiseDistribution.tuniform(17),
    pbs=GadgetParams(base_log=23, level=1),
    ks=GadgetParams(base_log=3, level=5),
    message_modulus=4,
    carry_modulus=4,
)

# Multi-bit PBS sets (tfhe-rs PARAM_MULTI_BIT_GROUP_{2,3}_MESSAGE_2_CARRY_2_
# KS_PBS_TUNIFORM_2M128 analogs): the classic set's GLWE, N, noise and
# message layout; GROUP_3 raises n 880 -> 882 so the group size divides it.
# GROUP_4 is the JAX package's own extension past tfhe-rs' GROUP_2/3.
# keygen reads the group size g from the name.
PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = dataclasses.replace(
    PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    name="PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
)
PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = dataclasses.replace(
    PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    name="PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
    lwe_dimension=882,
)
PARAM_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = dataclasses.replace(
    PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    name="PARAM_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
)

# Toy sets: no security, exact algorithms, for tests at small sizes.
TOY_SHORTINT = ShortintParams(
    name="TOY_SHORTINT",
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=128,
    lwe_noise=NoiseDistribution.tuniform(10),
    glwe_noise=NoiseDistribution.tuniform(6),
    pbs=GadgetParams(base_log=12, level=2),
    ks=GadgetParams(base_log=4, level=3),
    message_modulus=4,
    carry_modulus=4,
)

TOY_SHORTINT_NOISELESS = dataclasses.replace(
    TOY_SHORTINT,
    name="TOY_SHORTINT_NOISELESS",
    lwe_noise=NoiseDistribution.zero(),
    glwe_noise=NoiseDistribution.zero(),
)

TOY_SHORTINT_CORPUS = dataclasses.replace(
    TOY_SHORTINT_NOISELESS,
    name="TOY_SHORTINT_CORPUS",
    polynomial_size=256,
    lwe_dimension=8,
)

_REGISTRY = {
    p.name: p
    for p in [
        PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        PARAM_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        TOY_SHORTINT,
        TOY_SHORTINT_NOISELESS,
        TOY_SHORTINT_CORPUS,
    ]
}


def by_name(name: str) -> ShortintParams:
    return _REGISTRY[name]


def registry() -> dict:
    return dict(_REGISTRY)

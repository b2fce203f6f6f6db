"""Carry keys of the JAX package (tfhe_tpu) across to the port.

The functions read the reference objects' fields as numpy arrays
(`np.asarray`) and never import JAX or tfhe_tpu: a ClientKey / ServerKey
of tfhe_tpu.models.shortint (classic or multi-bit keys) becomes the
port's, bit for bit, so both packages can run on the same key material
and ciphertexts.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch import _u64
from tfhe_tpu_torch.core.bootstrap import BootstrapKey
from tfhe_tpu_torch.core.keys import GlweSecretKey, LweSecretKey
from tfhe_tpu_torch.core.lwe import KeyswitchKey
from tfhe_tpu_torch.core.multibit import MultiBitBootstrapKey
from tfhe_tpu_torch.models.shortint import ClientKey, ServerKey
from tfhe_tpu_torch.params import GadgetParams, NoiseDistribution, ShortintParams


def u64_tensor(a, device="cpu") -> torch.Tensor:
    """numpy/array-like u64 -> int64 tensor with the same bits."""
    return _u64.u64_from_numpy(np.asarray(a)).to(device)


def u32_tensor(a, device="cpu") -> torch.Tensor:
    """numpy/array-like u32 -> int32 tensor with the same bits."""
    a = np.array(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def gadget_from_reference(g) -> GadgetParams:
    return GadgetParams(base_log=g.base_log, level=g.level)


def noise_from_reference(d) -> NoiseDistribution:
    return NoiseDistribution(kind=d.kind, bound_log2=d.bound_log2, std=d.std)


def params_from_reference(p) -> ShortintParams:
    return ShortintParams(
        name=p.name,
        lwe_dimension=p.lwe_dimension,
        glwe_dimension=p.glwe_dimension,
        polynomial_size=p.polynomial_size,
        lwe_noise=noise_from_reference(p.lwe_noise),
        glwe_noise=noise_from_reference(p.glwe_noise),
        pbs=gadget_from_reference(p.pbs),
        ks=gadget_from_reference(p.ks),
        message_modulus=p.message_modulus,
        carry_modulus=p.carry_modulus,
    )


def client_key_from_reference(ck, device="cpu") -> ClientKey:
    return ClientKey(
        glwe_key=GlweSecretKey(key=u64_tensor(ck.glwe_key.key, device)),
        lwe_key=LweSecretKey(key=u64_tensor(ck.lwe_key.key, device)),
        params=params_from_reference(ck.params),
    )


def bootstrap_key_from_reference(bsk, device="cpu") -> BootstrapKey:
    return BootstrapKey(
        bsk_ntt=u32_tensor(bsk.bsk_ntt, device),
        gadget=gadget_from_reference(bsk.gadget),
        shift=int(bsk.shift),
        rot_table=None if bsk.rot_table is None else u32_tensor(bsk.rot_table, device),
    )


def multibit_bootstrap_key_from_reference(bsk, device="cpu") -> MultiBitBootstrapKey:
    return MultiBitBootstrapKey(
        bsk_ntt=u32_tensor(bsk.bsk_ntt, device),
        gadget=gadget_from_reference(bsk.gadget),
        shift=int(bsk.shift),
        group_size=int(bsk.group_size),
        rot_table=None if bsk.rot_table is None else u32_tensor(bsk.rot_table, device),
    )


def keyswitch_key_from_reference(ksk, device="cpu") -> KeyswitchKey:
    return KeyswitchKey(
        ksk=u64_tensor(ksk.ksk, device),
        ksk_limbs=torch.from_numpy(np.array(ksk.ksk_limbs, dtype=np.int8)).to(device),
        gadget=gadget_from_reference(ksk.gadget),
    )


def server_key_from_reference(sk, device="cpu") -> ServerKey:
    """Classic or multi-bit: a bootstrap key with a `group_size` is a
    tfhe_tpu MultiBitBootstrapKey."""
    if hasattr(sk.bsk, "group_size"):
        bsk = multibit_bootstrap_key_from_reference(sk.bsk, device)
    else:
        bsk = bootstrap_key_from_reference(sk.bsk, device)
    return ServerKey(
        bsk=bsk,
        ksk=keyswitch_key_from_reference(sk.ksk, device),
        params=params_from_reference(sk.params),
    )


def keys_from_reference(ck, sk, device="cpu") -> tuple[ClientKey, ServerKey]:
    """(ClientKey, ServerKey) of tfhe_tpu -> the port's, on `device`."""
    return client_key_from_reference(ck, device), server_key_from_reference(sk, device)

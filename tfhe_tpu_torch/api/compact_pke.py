"""Compact public-key encryption with casting keyswitch (counterpart of
tfhe_tpu/api/compact_pke.py).

The reference encrypts inputs under DEDICATED compact-PKE parameters and
casts into the compute parameter set server-side (reference:
sdk/relayer/src/tfhe.ts:17-26 V1_0_PARAM_PKE_MESSAGE_2_CARRY_2... +
ShortintKeySwitchingParameters; sdk/encrypt.ts:71-150 packs <= 256
values / <= 2048 bits into one CompactCiphertextList whose values share
mask material).

Construction (the GLWE form of compact lists):

- PKE key: a GLWE secret key over dedicated (k_pke, N_pke) params.
- PKE public key: M GLWE zero-encryptions; encrypting a batch of up to
  N_pke block values packs them as COEFFICIENTS of one plaintext
  polynomial and produces ONE GLWE ciphertext:
      ct = sum_i r_i * PK_i + (0, mu(X))
  so N_pke values share k_pke*N_pke mask words -- the compact list.
  r is binary, so r . PK is `public_key.binary_combination` (int8 limb
  products; CUDA has no 64-bit matmul).
- Expansion (server-side): sample-extract each used coefficient into an
  LWE under the flattened PKE key, then CASTING KEYSWITCH into the
  compute key via a standard LWE keyswitch key (the
  ShortintKeySwitchingParameters role).
"""

from __future__ import annotations

import dataclasses

import torch

from tfhe_tpu_torch.api.public_key import binary_combination
from tfhe_tpu_torch.core.glwe import encrypt_glwe
from tfhe_tpu_torch.core.keys import gen_glwe_secret_key, glwe_to_lwe_secret_key
from tfhe_tpu_torch.core.lwe import KeyswitchKey, gen_keyswitch_key, keyswitch, sample_extract_all
from tfhe_tpu_torch.models.integer import _u64_values
from tfhe_tpu_torch.models.shortint import ClientKey
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from tfhe_tpu_torch.params import GadgetParams, NoiseDistribution, ShortintParams
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import encode


@dataclasses.dataclass(frozen=True)
class PkeParams:
    """Dedicated compact-PKE parameter set (the V1_0_PARAM_PKE_* role);
    the JAX package's values."""

    name: str
    glwe_dimension: int
    polynomial_size: int
    noise: NoiseDistribution
    casting_ks: GadgetParams


PKE_PARAMS_2M128 = PkeParams(
    name="V1_PKE_MESSAGE_2_CARRY_2_TUNIFORM_2M128",
    glwe_dimension=1,
    polynomial_size=1024,
    noise=NoiseDistribution.tuniform(42),
    casting_ks=GadgetParams(base_log=3, level=5),
)

TOY_PKE = PkeParams(
    name="TOY_PKE",
    glwe_dimension=1,
    polynomial_size=128,
    noise=NoiseDistribution.tuniform(6),
    casting_ks=GadgetParams(base_log=4, level=3),
)


@dataclasses.dataclass
class CompactPkeKeySet:
    """Server-held: PKE secret key material + the casting key into the
    compute parameter set."""

    pke_pk: torch.Tensor  # (M, k+1, N) GLWE zero-encryptions
    casting_ksk: KeyswitchKey
    params: PkeParams
    compute_params: ShortintParams


@dataclasses.dataclass
class CompactCiphertextList:
    """One GLWE ciphertext per N_pke values (the shared-mask compact
    list); `n_values` coefficients are meaningful."""

    glwes: torch.Tensor  # (n_lists, k+1, N)
    params: PkeParams
    n_values: int


def gen_compact_pke_keys(ck: ClientKey, pke: PkeParams, rng: FheRng, n_rows: int | None = None) -> CompactPkeKeySet:
    """Generate the PKE keypair + casting keyswitch key on the client key's
    device (draw order: PKE secret, public key, casting key). The public
    key holds n_rows zero encryptions (default, as for 0, k*N + 128).

    The PKE secret never leaves this function -- only the public key and
    the casting KSK (encrypted under the COMPUTE key) are needed
    afterwards, exactly the reference's key-material split."""
    dev = ck.device
    engine = get_folded_engine(pke.polynomial_size, device=dev)
    pke_sk = gen_glwe_secret_key(rng, pke.glwe_dimension, pke.polynomial_size)
    m = n_rows or (pke.glwe_dimension * pke.polynomial_size + 128)
    pk = encrypt_glwe(
        pke_sk,
        torch.zeros((m, pke.polynomial_size), dtype=torch.int64, device=dev),
        rng,
        pke.noise,
        engine,
    )
    flat = glwe_to_lwe_secret_key(pke_sk)
    casting = gen_keyswitch_key(flat, ck.big_lwe_key, pke.casting_ks, rng, ck.params.glwe_noise)
    return CompactPkeKeySet(pke_pk=pk, casting_ksk=casting, params=pke, compute_params=ck.params)


def compact_pke_encrypt_with_witness(
    keys: CompactPkeKeySet, block_values, rng: FheRng
) -> tuple[CompactCiphertextList, torch.Tensor, torch.Tensor]:
    """Like `compact_pke_encrypt`, also returning the encryption witness
    (r, e) the ZK proof of plaintext knowledge needs (api/zkpok.py --
    reference builds the proof inside build_with_proof_packed,
    encrypt.ts:185-189). Draw order: r, then the noise."""
    pke = keys.params
    n = pke.polynomial_size
    dev = keys.pke_pk.device
    vals = _u64_values(block_values, dev).reshape(-1)
    v = vals.shape[0]
    n_lists = -(-v // n)
    padded = torch.zeros((n_lists * n,), dtype=torch.int64, device=dev)
    padded[:v] = vals
    pt = encode(padded.reshape(n_lists, n), keys.compute_params.delta)
    m = keys.pke_pk.shape[0]
    r = rng.binary((n_lists, m)).to(dev)
    ct = binary_combination(r, keys.pke_pk.reshape(m, -1)).reshape(n_lists, *keys.pke_pk.shape[1:])
    e = rng.noise(pke.noise, (n_lists, n)).to(dev)
    ct[:, -1, :] += pt + e
    return CompactCiphertextList(glwes=ct, params=pke, n_values=v), r, e


def compact_pke_encrypt(keys: CompactPkeKeySet, block_values, rng: FheRng) -> CompactCiphertextList:
    """block_values: (V,) shortint block values -> ceil(V / N_pke) GLWEs.

    Client-side: needs only the public key."""
    lst, _, _ = compact_pke_encrypt_with_witness(keys, block_values, rng)
    return lst


def expand(keys: CompactPkeKeySet, lst: CompactCiphertextList) -> torch.Tensor:
    """Server-side expansion: extract every coefficient as an LWE under
    the flattened PKE key (one gather), then casting-keyswitch the first
    n_values rows into the compute key. Returns (V, n_compute+1) int64
    shortint-encoded LWE blocks. (The JAX package keyswitches a
    power-of-two bucket of rows to bound its compiles and then slices;
    the keyswitch is row by row, so the kept rows are the same.)"""
    lwes = sample_extract_all(lst.glwes)  # (n_lists, N, k*N+1)
    flat = lwes.reshape(-1, lwes.shape[-1])[: lst.n_values]
    return keyswitch(flat, keys.casting_ksk)

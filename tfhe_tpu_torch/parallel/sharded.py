"""Distributed PBS: batch sharding and intra-PBS sharding over a mesh
(counterpart of tfhe_tpu/parallel/sharded.py).

The step (keyswitch -> blind rotate -> sample extract) runs on every rank
of a ("data", "model") mesh, each on its own shards:

  * the ciphertext batch is split over "data" (no communication);
  * the keyswitch key is split over its input dimension and the bootstrap
    key over its GGSW decomposition rows along "model"; each rank
    contracts its shard and the partial sums are all-reduced over
    "model" (one all-reduce for the keyswitch, one per rotation step on
    the NTT-domain residue sums, before the inverse transform).

Every step of the rotation is the loop form of the JAX package's sharded
step, whatever the key: rotate, decompose and forward-transform all D
digit rows (K1 on the card), contract this rank's rows, all-reduce,
inverse-transform (K2). `shard_inputs` cuts one rank's shards out of the
whole batch and keys, as the step's in_specs do in JAX.
"""

from __future__ import annotations

import math

import torch

from tfhe_tpu_torch.core.ggsw import contract_residues, decompose_forward, finalize_residues
from tfhe_tpu_torch.core.lwe import limb_product, limb_rhs, sample_extract
from tfhe_tpu_torch.parallel._comm import all_reduce_sum
from tfhe_tpu_torch.parallel.mesh import Mesh
from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate, signed_decompose


def _keyswitch_sharded(ct: torch.Tensor, ksk_local: torch.Tensor, rhs: torch.Tensor, gadget, mesh: Mesh,
                       axis: str):
    """Keyswitch with the KSK split over its n_in axis along `axis`.

    This rank holds KSK rows [idx * n_loc, (idx + 1) * n_loc) and takes
    the same slice of the digits; one `limb_product` of those digits
    against the local key's limbs (`rhs`, its `limb_rhs`), a
    sum-all-reduce over the axis (int64, wrapping mod 2^64), then the
    negation and the body, as core/lwe.keyswitch."""
    n_loc, level, m = ksk_local.shape
    idx = mesh.coord(axis)
    batch = ct.shape[:-1]
    if n_loc * mesh.size(axis) != ct.shape[-1] - 1:
        raise ValueError(f"{n_loc} KSK rows a rank x {mesh.size(axis)} ranks != n_in = {ct.shape[-1] - 1}")
    digits = signed_decompose(ct[..., :-1], gadget)  # (..., n_in, level)
    local = digits[..., idx * n_loc:(idx + 1) * n_loc, :]
    flat = local.reshape(-1, n_loc * level)
    partial = limb_product(flat, rhs, m, 1 << (gadget.base_log - 1))
    total = all_reduce_sum(partial, mesh, axis)
    out = (-total).reshape(*batch, m)
    out[..., -1] += ct[..., -1]
    return out


def _blind_rotate_sharded(lut, lwe_ct, bsk_local, gadget, engine, mesh: Mesh, axis: str, shift: int = 0):
    """Blind rotation with the BSK split over its GGSW rows along `axis`:
    bsk_local (n, D_loc, k+1, P, 2, N), this rank's rows
    [idx * D_loc, (idx + 1) * D_loc).

    Each step's contracted residues are canonical ([0, p)); their sum over
    the M ranks of the axis is all-reduced as contract_residues returns it,
    int32, and goes through one condsub_domain to the inverse transform, as
    in JAX. The sum is below M * p < 2^32 for M <= 4 (the int32 lane holds
    the u32 bits JAX's uint32 psum holds), and condsub_domain brings it
    into [0, 2p). For M > 4 the inverse is fed more than 2p, as in JAX."""
    n_poly = lut.shape[-1]
    two_n = 2 * n_poly
    d_loc = bsk_local.shape[1]
    idx = mesh.coord(axis)
    d_rows = lut.shape[-2] * gadget.level
    if d_loc * mesh.size(axis) != d_rows:
        raise ValueError(f"{d_loc} GGSW rows a rank x {mesh.size(axis)} ranks != D = {d_rows}")
    ms = mod_switch(lwe_ct, int(math.log2(two_n)))
    a_t = ms[..., :-1]
    b_t = ms[..., -1]
    acc = negacyclic_monomial_rotate(lut, (two_n - b_t)[..., None])
    acc = acc.expand(*b_t.shape, lut.shape[-2], n_poly)
    a_steps = a_t.movedim(-1, 0)
    for j in range(bsk_local.shape[0]):
        rot = negacyclic_monomial_rotate(acc, a_steps[j][..., None])
        fd = decompose_forward(rot - acc, gadget, engine)  # (..., D, P, N)
        fd_loc = fd[..., idx * d_loc:(idx + 1) * d_loc, :, :]
        res = all_reduce_sum(contract_residues(bsk_local[j], fd_loc, engine), mesh, axis)
        acc = acc + finalize_residues(res, engine, shift=shift)
    return acc


def make_sharded_pbs_step(mesh: Mesh, engine, ks_gadget, pbs_gadget, bsk_shift: int | None = None):
    """Build this rank's distributed PBS step.

    Returns step(cts, lut, bsk_ntt, ksk_arr), all this rank's shards
    (`shard_inputs`):
      cts:     (B_loc, big_n+1) int64, the rank's rows of the batch
      lut:     (k+1, N) int64, whole
      bsk_ntt: (n, D_loc, k+1, P, 2, N) int32, its GGSW rows
      ksk_arr: (n_loc, level, n_small+1) int64, its KSK rows
    and returns the rank's (B_loc, big_n+1) bootstrapped ciphertexts.

    bsk_shift MUST match the key's modulus-switched storage
    (BootstrapKey.shift). The keyswitch key's limbs are made on the first
    call with a KSK tensor and kept while the step sees the same tensor.
    """
    assert bsk_shift is not None, "pass bsk_shift=sk.bsk.shift"
    limbs = {}

    def step(cts, lut, bsk_ntt, ksk_arr):
        if limbs.get("ksk") is not ksk_arr:
            n_loc, level, m = ksk_arr.shape
            limbs.update(ksk=ksk_arr, rhs=limb_rhs(ksk_arr.reshape(n_loc * level, m)))
        small = _keyswitch_sharded(cts, ksk_arr, limbs["rhs"], ks_gadget, mesh, "model")
        acc = _blind_rotate_sharded(lut, small, bsk_ntt, pbs_gadget, engine, mesh, "model", shift=bsk_shift)
        return sample_extract(acc, 0)

    return step


def shard_inputs(mesh: Mesh, cts, bsk_ntt, ksk_arr, batch_axes=("data",)):
    """This rank's shards of the whole batch and keys (the JAX step's
    in_specs): the rows of `cts` over `batch_axes`, the BSK's D axis and
    the KSK's n_in axis over "model", each on the mesh's device."""
    dev = mesh.device
    return (
        mesh.local_block(cts, 0, batch_axes).to(dev),
        mesh.local_block(bsk_ntt, 1, "model").contiguous().to(dev),
        mesh.local_block(ksk_arr, 0, "model").contiguous().to(dev),
    )

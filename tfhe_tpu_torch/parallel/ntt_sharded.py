"""Cross-rank NTT-stage sharding and key-sharded blind rotation
(counterpart of tfhe_tpu/parallel/ntt_sharded.py).

1. Distributed four-step NTT. The folded NTT factors N = C*R with
     stage 1: y[t,r] = sum_c V[t,c] * x[c,r]      (contract C)
     twist:   y'[t,r] = G[t,r] * y[t,r]
     stage 2: out[t*R+s] = sum_r W[s,r] * y'[t,r] (contract R, local in t)
   A single polynomial split over the M ranks of an axis along the C view
   makes stage 1 the only cross-rank step: each rank contracts its C rows
   and one reduce-scatter over t re-shards the partial sums, so the twist
   and stage 2 are local. One reduce-scatter per prime per direction; the
   inverse is symmetric (contract t in its last stage, reduce-scatter
   over c). Plain tensor code with exact mod-p int64 arithmetic: a
   collective path, not a kernel.

2. Key-sharded blind rotation. The GGSW chain is split along the STEP
   axis: rank d holds steps [d*n/M, (d+1)*n/M), the only copy. The
   accumulator of the whole batch walks the ring: in phase d rank d
   applies its steps (the loop form, K1 and K2 once per step on the
   card), then every rank hands its accumulator to (d + 1) % M. After M
   phases the finished accumulator is on rank 0, which broadcasts it.
   The JAX function's docstring describes a microbatched pipeline of
   2M - 1 phases; its code runs these M phases over the whole batch, and
   so does this port. JAX computes the phase on every device and keeps
   rank d's; here only rank d computes. The result is bit-identical to
   the single-device rotation.
"""

from __future__ import annotations

import math

import torch

from tfhe_tpu_torch import _u64
from tfhe_tpu_torch.core.ggsw import contract_residues, decompose_forward, finalize_residues
from tfhe_tpu_torch.ops.polynomial import _primitive_root
from tfhe_tpu_torch.parallel._comm import broadcast, reduce_scatter_sum, ring_hop
from tfhe_tpu_torch.parallel.mesh import Mesh
from tfhe_tpu_torch.torus import mod_switch, negacyclic_monomial_rotate


def _stage_tables(engine) -> tuple:
    """Exact (mod p) stage matrices per prime as int64 tensors on the
    engine's device: V (P, C, C), G (P, C, R), W (P, R, R) forward and
    Wi, Gi, Vi inverse, built from Python ints (p < 2^30, so a product of
    two residues stays below 2^60). Built once per engine."""
    tabs = engine.__dict__.get("_stage_tables")
    if tabs is not None:
        return tabs
    n = engine.n
    rd, cd = engine.ntts[0].r_dim, engine.ntts[0].c_dim
    vs, gs, ws, wis, gis, vis = [], [], [], [], [], []
    for p in engine.primes:
        g = _primitive_root(p)
        psi = pow(g, (p - 1) // (2 * n), p)
        omega = psi * psi % p
        om_r = pow(omega, cd, p)
        om_c = pow(omega, rd, p)
        psi_inv = pow(psi, p - 2, p)
        om_inv = pow(omega, p - 2, p)
        n_inv = pow(n, p - 2, p)
        om_r_inv = pow(om_r, p - 2, p)
        om_c_inv = pow(om_c, p - 2, p)
        vs.append([[pow(om_c, c * t, p) * pow(psi, rd * c, p) % p for c in range(cd)] for t in range(cd)])
        gs.append([[pow(pow(omega, t, p) * psi % p, r, p) for r in range(rd)] for t in range(cd)])
        ws.append([[pow(om_r, r * s, p) for r in range(rd)] for s in range(rd)])
        wis.append([[pow(om_r_inv, r * s, p) for s in range(rd)] for r in range(rd)])
        gis.append([[pow(pow(om_inv, t, p) * psi_inv % p, r, p) * n_inv % p for r in range(rd)]
                    for t in range(cd)])
        vis.append([[pow(om_c_inv, c * t, p) * pow(psi_inv, rd * c, p) % p for t in range(cd)]
                    for c in range(cd)])
    tabs = tuple(torch.tensor(t, dtype=torch.int64, device=engine.device) for t in (vs, gs, ws, wis, gis, vis))
    engine.__dict__["_stage_tables"] = tabs
    return tabs


def _matmod(m: torch.Tensor, x: torch.Tensor, p: int) -> torch.Tensor:
    """(A, K) x (K, B) mod p, exact: each product reduced before the sum
    (K <= 128 canonical products < 2^30 sum below 2^37)."""
    prods = (m[:, :, None] * x[None, :, :]) % p  # (A, K, B)
    return prods.sum(dim=1) % p


def make_sharded_ntt(engine, mesh: Mesh, axis: str = "model"):
    """Build (forward, inverse) of one polynomial split along the folded C
    view over `axis`.

    forward(x_loc): this rank's C-block of x, (C_loc * R,) int64 holding
      u64 -> (P, C_loc * R) int64 canonical residues, this rank's t-block
      of the folded layout h = t*R + s. Equal mod p to
      engine.forward_u64(x) at those columns.
    inverse(f_loc): (P, C_loc * R) residues (any u32 < 2^32, int32 or
      int64), t-block -> (P, C_loc * R) int64 canonical residues, this
      rank's C-block of x mod each prime.
    """
    v_t, g_t, w_t, wi_t, gi_t, vi_t = _stage_tables(engine)
    rd, cd = engine.ntts[0].r_dim, engine.ntts[0].c_dim
    m_dev = mesh.size(axis)
    if cd % m_dev:
        raise ValueError(f"C = {cd} does not split over {m_dev} ranks")
    c_loc = cd // m_dev
    primes = engine.primes

    def forward(x_loc: torch.Tensor) -> torch.Tensor:
        idx = mesh.coord(axis)
        xm = x_loc.to(torch.int64).reshape(c_loc, rd)
        lo = slice(idx * c_loc, (idx + 1) * c_loc)
        outs = []
        for i, p in enumerate(primes):
            xr = _u64.umod(xm, p)
            y_part = _matmod(v_t[i][:, lo], xr, p)  # (C, R), partial over local c
            y = reduce_scatter_sum(y_part, mesh, axis) % p  # (C_loc_t, R)
            yt = (y * g_t[i][lo]) % p
            outs.append(_matmod(w_t[i], yt.T, p).T.reshape(-1))  # (C_loc_t, R_s)
        return torch.stack(outs)

    def inverse(f_loc: torch.Tensor) -> torch.Tensor:
        idx = mesh.coord(axis)
        f = _u64.u32(f_loc) if f_loc.dtype == torch.int32 else f_loc.to(torch.int64)
        lo = slice(idx * c_loc, (idx + 1) * c_loc)
        outs = []
        for i, p in enumerate(primes):
            fm = _u64.umod(f[i].reshape(c_loc, rd), p)
            u = _matmod(wi_t[i], fm.T, p).T  # (C_loc_t, R_r), local stage
            ut = (u * gi_t[i][lo]) % p
            a_part = _matmod(vi_t[i][:, lo], ut, p)  # (C, R), partial over local t
            outs.append((reduce_scatter_sum(a_part, mesh, axis) % p).reshape(-1))  # (C_loc_c, R)
        return torch.stack(outs)

    return forward, inverse


# -- key-sharded blind rotation ----------------------------------------------


def make_key_sharded_blind_rotate(engine, gadget, mesh: Mesh, axis: str = "model", shift: int = 0):
    """Blind rotation with the BSK split along the STEP axis over `axis`.

    Returns rotate(lut, cts, bsk_local): lut (k+1, N), cts (B, n+1) the
    whole batch of small-key ciphertexts on every rank, bsk_local
    (n / M, D, k+1, P, 2, N) this rank's steps. Every rank returns the
    whole rotated accumulator (B, k+1, N)."""
    m_dev = mesh.size(axis)

    def scan_steps(acc, bsk_loc, a_loc):
        for j in range(bsk_loc.shape[0]):
            rot = negacyclic_monomial_rotate(acc, a_loc[j][..., None])
            fd = decompose_forward(rot - acc, gadget, engine)
            acc = acc + finalize_residues(contract_residues(bsk_loc[j], fd, engine), engine, shift=shift)
        return acc

    def rotate(lut, cts, bsk_local):
        n_poly = lut.shape[-1]
        two_n = 2 * n_poly
        idx = mesh.coord(axis)
        n_loc = bsk_local.shape[0]
        ms = mod_switch(cts, int(math.log2(two_n)))
        a_all = ms[..., :-1].movedim(-1, 0)  # (n, B)
        if n_loc * m_dev != a_all.shape[0]:
            raise ValueError(f"{n_loc} BSK steps a rank x {m_dev} ranks != n = {a_all.shape[0]}")
        acc = negacyclic_monomial_rotate(lut, (two_n - ms[..., -1])[..., None])
        out = acc.expand(*ms.shape[:-1], lut.shape[-2], n_poly).contiguous()
        for dev in range(m_dev):
            if idx == dev:
                out = scan_steps(out, bsk_local, a_all[idx * n_loc:(idx + 1) * n_loc])
            out = ring_hop(out, mesh, axis)
        # after M hops the finished accumulator is back on coordinate 0
        return broadcast(out.contiguous(), mesh, axis)

    return rotate

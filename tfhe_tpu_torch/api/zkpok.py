"""Zero-knowledge proof of plaintext knowledge for compact-PKE inputs.

Role of the reference's CPKE zero-knowledge proof: the client proves it
KNOWS the plaintext and encryption randomness of the CompactCiphertextList
it submits, bound to auxData = contract || user || acl || chainId, and the
coprocessor verifies the proof BEFORE its quorum signs the input handles
(reference: sdk/relayer/src/sdk/encrypt.ts:174-189
`builder.build_with_proof_packed(crs, auxData, ZkComputeLoad.Verify)`;
CRS sized for 2048 bits at sdk/relayer/src/tfhe.ts:24-26; WASM surface
`CompactPkeCrs` at sdk/relayer/src/tfheType.ts:14-23). Without this proof
an attacker can replay or maul someone else's ciphertext into a contract
and use the contract's decryption policy as an oracle.

Construction (from scratch, framework native -- the host-side part of
the input pipeline):

A Fiat-Shamir Sigma-protocol with binary challenges and rejection-sampled
uniform masks, proving knowledge of (r, m, e) such that for every GLWE in
the list (api/compact_pke.py construction):

    ct_mask = r . PK_mask                          (mod 2^64)
    ct_body = r . PK_body + Delta * m + e          (mod 2^64)

with r the binary public-key combination vector, m the plaintext block
values (< message_modulus), and e the TUniform(b) encryption noise.

Protocol (R = 8 repetitions x 16-bit challenges):
  witness  w = (r, m, limbs of e + 2^b)  -- noise shifted nonnegative,
           then split into E base-2^22 limbs so every per-limb bound
           B_e = 2^(22 + CHAL_BITS + STAT_LOG) fits u64 even at the
           production TUniform(42) noise (one limb when b is small)
  masks    y_j ~ U[0, B_j)            -- per-component bound B_j
  commit   t_i = A . y_i              -- A is the linear map above
  chall    c = H(tag, crs, pk, ct, auxData, t_1..t_R), R 16-bit values
  resp     z_i = y_i + c_i * w        -- over the integers (< 2^55, no wrap)
  reject+retry unless every z in [M0, B), M0 = c_max * w_max
           (Lyubashevsky-style aborts; the abort probability is M0/B
           per coefficient, INDEPENDENT of the witness value, and
           accepted z are uniform on [M0, B))
  proof    = (c, z_1..z_R) with every z column BYTE-PACKED to its bound
           width (5/5/7 bytes at production parameters); the verifier
           recomputes t_i = A.z_i - c_i*s and checks the hash and the
           bounds  (s = (ct_mask, ct_body + 2^b)).

Size: R * L * (M*5 + N*5 + N*7) bytes ~ 278 KB at production parameters
(N = M = 2048, L = 1) -- 22x smaller than the round-4 binary-challenge
version (128 reps x 8-byte words ~ 6.3 MB). Verification cost drops by
the same 16x repetition factor.

Security statement (documented honestly -- see DELTA below):
- Completeness: exact (restart on the rare abort).
- Soundness 2^-128: the challenge vector lives in (2^16)^8; a prover
  answering two transcripts that differ at repetition i yields
  A.(z_i - z'_i) = (c_i - c'_i).s (mod 2^64) with short z-differences --
  the standard RELAXED extraction of lattice Sigma-protocols, now with a
  relaxation factor |c_i - c'_i| < 2^16 on top of the rejection-window
  slack (binary challenges had factor exactly 1). Producing such a short
  relaxed preimage for a ciphertext you did not encrypt yourself is an
  inhomogeneous-SIS-style problem over Z_2^64 at norm B_e << q;
  plaintext knowledge therefore holds computationally.
- Zero-knowledge: perfect HVZK -- accepted responses are uniform on
  [M0, B) independent of the witness, commitments are determined by
  (z, c, s); the simulator samples z first. Non-interactive via
  Fiat-Shamir in the random-oracle model (keccak256), with the CRS hash,
  public-key digest, ciphertext and auxData all bound into the challenge.

DELTA vs the reference: tfhe-rs' CPKE proof (pke_v2) is pairing-based and
EXACT (no slack) with constant-size proofs; this proof is transparent
(no trusted setup -- the "CRS" here pins parameters/bounds and a domain
separator), has slack factor 2^(STAT_LOG + CHAL_BITS) on the extracted
norms, and is ~278 KB at production parameters. The slack means range
soundness is
"m < B_m" rather than "m < message_modulus": a dishonest prover can
encode an over-range block up to the slack bound. Downstream this is
equivalent to submitting a noisy/garbage input the prover KNOWS -- the
plaintext-knowledge property (no ciphertext stealing) is what the fhevm
threat model needs and is preserved. PARITY.md tracks this delta.
"""

from __future__ import annotations

import dataclasses
import json
import secrets

import numpy as np
import torch

from tfhe_tpu_torch.api.compact_pke import CompactCiphertextList, PkeParams
from tfhe_tpu_torch.params import ShortintParams
from tfhe_tpu_torch.utils.keccak import keccak256

# the JAX package's domain tag: proofs verify across the two packages
_TAG = b"tfhe_tpu/zkpok/cpke/v2"
REPS = 8  # x 16-bit challenges -> 2^-128 Fiat-Shamir error
CHAL_BITS = 16  # challenge space per repetition
STAT_LOG = 20  # rejection-window slack log2 (abort ~2^-20 per coefficient)
E_LIMB_BITS = 22  # noise limb width: 22+1+16+20 = 59 < 63, no u64 wrap
_MAX_ATTEMPTS = 64


def host_u64(x) -> np.ndarray:
    """An array of the statement or witness as host u64: a tensor (int64
    carrying u64 bits, on any device) through a `.cpu()` u64 view, any
    other array-like through numpy. The proof is host numpy work."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.int64).cpu().numpy().view(np.uint64)
    return np.asarray(x, dtype=np.uint64)


class ZkProofError(Exception):
    """Verification failure -- callers must fail closed."""


@dataclasses.dataclass(frozen=True)
class CompactPkeCrs:
    """Public parameters binding the proof system to one PKE parameter
    set and input-size budget (role of the reference's `CompactPkeCrs`,
    tfhe.ts:24-26 `CompactPkeCrs.from_config(config, 4*512)`).

    Transparent: there is no trapdoor material, only the parameter
    digest, the size budget and the norm bounds -- hashed into every
    Fiat-Shamir challenge so proofs are non-transferable across CRS."""

    pke_params_name: str
    max_num_bits: int
    message_modulus: int
    delta: int
    noise_bound_log2: int  # TUniform b of the PKE noise
    reps: int
    chal_bits: int  # challenge space log2 per repetition
    b_r_log2: int  # mask bound for the binary r components
    b_m_log2: int  # mask bound for the message components
    e_limb_bits: int  # shifted noise splits into base-2^this limbs
    e_limbs: int  # number of noise limbs E (1 when the bound is small)
    b_e_log2: int  # mask bound for each shifted-noise LIMB

    @classmethod
    def from_params(
        cls,
        pke: PkeParams,
        compute: ShortintParams,
        max_num_bits: int = 2048,
    ) -> "CompactPkeCrs":
        if pke.noise.kind != "tuniform":
            raise ValueError("CPKE proof requires TUniform PKE noise")
        b = pke.noise.bound_log2
        mm_bits = max(int(compute.message_modulus).bit_length(), 1)
        limb = min(b + 1, E_LIMB_BITS)
        return cls(
            pke_params_name=pke.name,
            max_num_bits=max_num_bits,
            message_modulus=int(compute.message_modulus),
            delta=int(compute.delta),
            noise_bound_log2=b,
            reps=REPS,
            chal_bits=CHAL_BITS,
            # every bound carries the challenge slack: z = y + c*w with
            # c < 2^chal_bits, so B >= 2^chal_bits * w_max * 2^STAT_LOG
            b_r_log2=CHAL_BITS + STAT_LOG,  # w_max = 1
            b_m_log2=CHAL_BITS + STAT_LOG + mm_bits,
            e_limb_bits=limb,
            e_limbs=-(-(b + 1) // limb),  # ceil: covers e' <= 2^(b+1)
            b_e_log2=limb + 1 + CHAL_BITS + STAT_LOG,
        )

    @property
    def hash(self) -> bytes:
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True).encode()
        return keccak256(_TAG + payload)


def _pack_u64(a: np.ndarray, nbytes: int) -> bytes:
    """Little-endian byte-pack: keep only the low `nbytes` bytes of each
    u64 (exact when every value < 2^(8*nbytes))."""
    le = np.ascontiguousarray(a.astype("<u8")).view(np.uint8)
    return le.reshape(-1, 8)[:, :nbytes].tobytes()


def _unpack_u64(data: bytes, shape: tuple, nbytes: int) -> np.ndarray:
    n = int(np.prod(shape))
    raw = np.frombuffer(data, dtype=np.uint8)
    if raw.size != n * nbytes:
        raise ZkProofError("packed array size mismatch")
    full = np.zeros((n, 8), dtype=np.uint8)
    full[:, :nbytes] = raw.reshape(n, nbytes)
    return full.view("<u8").reshape(shape).astype(np.uint64)


def _pack_widths(crs: "CompactPkeCrs") -> tuple[int, int, int]:
    """(r, m, e) packed bytes per response entry, from the CRS bounds."""
    return (
        (crs.b_r_log2 + 7) // 8,
        (crs.b_m_log2 + 7) // 8,
        (crs.b_e_log2 + 7) // 8,
    )


@dataclasses.dataclass
class CompactPkeProof:
    """(c, z) transcript; commitments are recomputed by the verifier.
    Serialized responses are byte-packed to their CRS bound widths
    (5/5/7 bytes per entry at production parameters vs 8 raw)."""

    challenge: bytes  # reps * chal_bits/8 bytes (big-endian u16 each)
    z_r: np.ndarray  # (reps, L, M) u64
    z_m: np.ndarray  # (reps, L, N) u64
    z_e: np.ndarray  # (reps, L, E, N) u64 noise limbs

    def to_bytes(self) -> bytes:
        widths = [
            min(8, max(1, (int(z.max(initial=0)).bit_length() + 7) // 8))
            for z in (self.z_r, self.z_m, self.z_e)
        ]
        header = json.dumps(
            {
                "c": self.challenge.hex(),
                "shapes": [
                    list(self.z_r.shape),
                    list(self.z_m.shape),
                    list(self.z_e.shape),
                ],
                "widths": widths,
            }
        ).encode()
        return (
            len(header).to_bytes(4, "big")
            + header
            + _pack_u64(self.z_r, widths[0])
            + _pack_u64(self.z_m, widths[1])
            + _pack_u64(self.z_e, widths[2])
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "CompactPkeProof":
        hlen = int.from_bytes(data[:4], "big")
        header = json.loads(data[4 : 4 + hlen])
        shapes = [tuple(s) for s in header["shapes"]]
        widths = [int(w) for w in header.get("widths", [8, 8, 8])]
        if len(widths) != 3 or any(not 1 <= w <= 8 for w in widths):
            raise ZkProofError("malformed pack widths")
        off = 4 + hlen
        arrays = []
        for shape, w in zip(shapes, widths):
            n = int(np.prod(shape)) * w
            arrays.append(_unpack_u64(data[off : off + n], shape, w))
            off += n
        if off != len(data):
            raise ZkProofError("trailing bytes in proof")
        return cls(bytes.fromhex(header["c"]), *arrays)


def _pk_planes(pke_pk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(M, k+1, N) u64 public key -> flattened mask (M, k*N) and body
    (M, N) planes for the linear map."""
    pk = host_u64(pke_pk)
    m = pk.shape[0]
    mask = pk[:, :-1, :].reshape(m, -1)
    body = pk[:, -1, :]
    return mask, body


def _wrap_matmul_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a @ b) mod 2^64 via 16-bit-limb float64 BLAS matmuls.

    numpy's u64 matmul has no SIMD/BLAS path (~440 ms at the production
    M=N=2048 statement); splitting both operands into four 16-bit limbs
    gives exact f64 products (<= 2^32), and dgemm does the contraction
    ~20x faster. Exactness bound: weight k sums k+1 <= 4 matmuls of M
    products < 2^32 each, so the accumulator stays under 2^53 only for
    M <= 2^19 (4 * 2^19 * 2^32 = 2^53) — larger contractions take the
    exact u64 path. Only limb pairs with weight < 2^64 survive the wrap.
    Small problems also go direct: the 10-matmul limb overhead only wins
    once the contraction dominates (measured crossover ~512x512)."""
    if a.shape[-1] > 1 << 19:
        with np.errstate(over="ignore"):
            return a @ b
    if a.shape[-1] * b.shape[-1] <= 1 << 18:
        with np.errstate(over="ignore"):
            return a @ b
    mask16 = np.uint64(0xFFFF)
    al = [((a >> np.uint64(16 * i)) & mask16).astype(np.float64) for i in range(4)]
    bl = [((b >> np.uint64(16 * j)) & mask16).astype(np.float64) for j in range(4)]
    out = np.zeros(a.shape[:-1] + (b.shape[-1],), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for k in range(4):
            acc = al[0] @ bl[k]
            for i in range(1, k + 1):
                acc += al[i] @ bl[k - i]
            out += acc.astype(np.uint64) << np.uint64(16 * k)
    return out


def _apply_map(
    crs: CompactPkeCrs,
    pk_mask: np.ndarray,
    pk_body: np.ndarray,
    vr: np.ndarray,
    vm: np.ndarray,
    ve: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """A.(vr, vm, ve) for a stack of vectors: vr (..., M) -> mask
    (..., k*N) and body (..., N) images, all wrapping mod 2^64.
    ve: (..., E, N) noise limbs, weighted by 2^(e_limb_bits * j)."""
    with np.errstate(over="ignore"):
        t_mask = _wrap_matmul_u64(vr, pk_mask)
        e_total = np.zeros(ve.shape[:-2] + ve.shape[-1:], dtype=np.uint64)
        for j in range(crs.e_limbs):
            e_total += ve[..., j, :] << np.uint64(crs.e_limb_bits * j)
        t_body = (
            _wrap_matmul_u64(vr, pk_body) + np.uint64(crs.delta) * vm + e_total
        )
    return t_mask, t_body


def _statement(
    crs: CompactPkeCrs, lst: CompactCiphertextList
) -> tuple[np.ndarray, np.ndarray]:
    """Per-list statement vectors (s_mask, s_body) with the noise shift
    folded in: s_body = ct_body + 2^b (so A.w = s for the shifted witness)."""
    ct = host_u64(lst.glwes)  # (L, k+1, N)
    s_mask = ct[:, :-1, :].reshape(ct.shape[0], -1)
    with np.errstate(over="ignore"):
        s_body = ct[:, -1, :] + np.uint64(2**crs.noise_bound_log2)
    return s_mask, s_body


def _transcript_hash(
    crs: CompactPkeCrs,
    pk_digest: bytes,
    lst: CompactCiphertextList,
    aux_data: bytes,
    t_mask: np.ndarray,
    t_body: np.ndarray,
) -> bytes:
    ct = np.ascontiguousarray(host_u64(lst.glwes))
    h = keccak256(
        _TAG
        + crs.hash
        + pk_digest
        + len(aux_data).to_bytes(4, "big")
        + aux_data
        + lst.n_values.to_bytes(4, "big")
        + keccak256(ct.tobytes())
        + keccak256(np.ascontiguousarray(t_mask).tobytes())
        + keccak256(np.ascontiguousarray(t_body).tobytes())
    )
    return h[: REPS * CHAL_BITS // 8]


_PK_DIGEST_CACHE: dict = {}


def pk_digest(pke_pk) -> bytes:
    """keccak of the full public key (megabytes). The PK is a static
    per-instance object hashed on EVERY prove/verify, so memoize by
    object identity. The cache holds a STRONG reference to the keyed
    object and checks `is` on hit — a freed-and-reallocated array can
    never alias a live entry's id, so a hit is always the same object.
    (In-place mutation of a pk after first use is out of contract.)"""
    entry = _PK_DIGEST_CACHE.get(id(pke_pk))
    if entry is not None and entry[0] is pke_pk:
        return entry[1]
    arr = host_u64(pke_pk)
    d = keccak256(np.ascontiguousarray(arr).tobytes())
    if len(_PK_DIGEST_CACHE) > 16:
        _PK_DIGEST_CACHE.clear()
    _PK_DIGEST_CACHE[id(pke_pk)] = (pke_pk, d)
    return d


def _bounds(crs: CompactPkeCrs) -> list[tuple[int, int]]:
    """[(M0, B)] for (r, m, e-limb): M0 = c_max * w_max is the rejection
    window floor (z = y + c*w <= M0 + y), B the mask bound."""
    c_max = (1 << crs.chal_bits) - 1
    return [
        (c_max * 1, 1 << crs.b_r_log2),
        (c_max * (crs.message_modulus - 1), 1 << crs.b_m_log2),
        # top limb can equal 2^e_limb_bits when e' == 2^(b+1) exactly
        (c_max * (1 << crs.e_limb_bits), 1 << crs.b_e_log2),
    ]


def _challenges(c_bytes: bytes) -> np.ndarray:
    """Challenge bytes -> (REPS,) u64 values in [0, 2^CHAL_BITS)."""
    return np.frombuffer(c_bytes, dtype=">u2").astype(np.uint64)


def prove(
    crs: CompactPkeCrs,
    pke_pk,
    lst: CompactCiphertextList,
    r,
    msg_blocks,
    e,
    aux_data: bytes,
    seed: int | None = None,
) -> CompactPkeProof:
    """Prove knowledge of the encryption witness of `lst`.

    r: (L, M) binary combination vectors; msg_blocks: (V,) block values
    (< message_modulus -- the prover REFUSES out-of-range plaintexts);
    e: (L, N) TUniform noise as sampled (u64 two's complement). aux_data
    binds contract || user || acl || chainId exactly as the reference's
    auxData (encrypt.ts:174-184). The shifted noise is proven as
    crs.e_limbs base-2^e_limb_bits limbs (see module docstring)."""
    pk_mask, pk_body = _pk_planes(pke_pk)
    n = pk_body.shape[1]
    w_r = host_u64(r)
    ell = w_r.shape[0]
    vals = host_u64(msg_blocks).ravel()
    if vals.size != lst.n_values:
        raise ValueError("msg_blocks length != list n_values")
    if np.any(vals >= crs.message_modulus):
        raise ValueError("plaintext block out of range for the message modulus")
    if vals.size * int(np.log2(crs.message_modulus)) > crs.max_num_bits:
        raise ValueError("input exceeds the CRS bit budget")
    w_m = np.zeros((ell, n), dtype=np.uint64)
    w_m.reshape(-1)[: vals.size] = vals
    shift = np.uint64(1 << crs.noise_bound_log2)
    with np.errstate(over="ignore"):
        w_e = host_u64(e) + shift  # e' in [0, 2^(b+1)]
    if np.any(w_e > np.uint64(1 << (crs.noise_bound_log2 + 1))):
        raise ValueError("noise outside the TUniform bound")
    # base-2^e_limb_bits decomposition: (L, E, N), sum_j limb_j << (lb*j)
    lb = np.uint64(crs.e_limb_bits)
    lmask = np.uint64((1 << crs.e_limb_bits) - 1)
    w_e_limbs = np.stack(
        [(w_e >> (lb * np.uint64(j))) & lmask if j < crs.e_limbs - 1
         else (w_e >> (lb * np.uint64(j)))  # top limb keeps the carry
         for j in range(crs.e_limbs)],
        axis=-2,
    )  # (L, E, N)
    digest = pk_digest(pke_pk)
    bounds = _bounds(crs)
    rng = np.random.default_rng(
        seed if seed is not None else secrets.randbits(128)
    )
    for _ in range(_MAX_ATTEMPTS):
        y_r = rng.integers(0, bounds[0][1], size=(REPS, ell, w_r.shape[1]), dtype=np.uint64)
        y_m = rng.integers(0, bounds[1][1], size=(REPS, ell, n), dtype=np.uint64)
        y_e = rng.integers(
            0, bounds[2][1], size=(REPS, ell, crs.e_limbs, n), dtype=np.uint64
        )
        t_mask, t_body = _apply_map(crs, pk_mask, pk_body, y_r, y_m, y_e)
        c_bytes = _transcript_hash(crs, digest, lst, aux_data, t_mask, t_body)
        c = _challenges(c_bytes)[:, None, None]
        # z = y + c*w over the integers: every term < 2^55, no wrap
        z_r = y_r + c * w_r[None]
        z_m = y_m + c * w_m[None]
        z_e = y_e + c[..., None] * w_e_limbs[None]
        ok = True
        for z, (m0, b) in zip((z_r, z_m, z_e), bounds):
            if np.any(z < np.uint64(m0)) or np.any(z >= np.uint64(b)):
                ok = False
                break
        if ok:
            return CompactPkeProof(challenge=c_bytes, z_r=z_r, z_m=z_m, z_e=z_e)
    raise RuntimeError("rejection sampling failed to converge")


def verify(
    crs: CompactPkeCrs,
    pke_pk,
    lst: CompactCiphertextList,
    proof: CompactPkeProof,
    aux_data: bytes,
) -> None:
    """Raise ZkProofError unless `proof` verifies for (lst, aux_data).

    Checks, fail-closed: response shapes, response bounds, and the
    Fiat-Shamir hash over the RECOMPUTED commitments
    t_i = A.z_i - c_i * s (mod 2^64)."""
    pk_mask, pk_body = _pk_planes(pke_pk)
    n = pk_body.shape[1]
    ell = lst.glwes.shape[0]
    m_rows = pk_mask.shape[0]
    if (
        proof.z_r.shape != (REPS, ell, m_rows)
        or proof.z_m.shape != (REPS, ell, n)
        or proof.z_e.shape != (REPS, ell, crs.e_limbs, n)
    ):
        raise ZkProofError("malformed proof shapes")
    if len(proof.challenge) != REPS * CHAL_BITS // 8:
        raise ZkProofError("malformed challenge")
    if lst.n_values > ell * n or lst.n_values <= 0:
        raise ZkProofError("ciphertext list value count out of range")
    if lst.n_values * int(np.log2(crs.message_modulus)) > crs.max_num_bits:
        raise ZkProofError("input exceeds the CRS bit budget")
    for z, (_, b) in zip((proof.z_r, proof.z_m, proof.z_e), _bounds(crs)):
        if np.any(z >= np.uint64(b)):
            raise ZkProofError("response out of bounds")
    s_mask, s_body = _statement(crs, lst)
    c = _challenges(proof.challenge)[:, None, None]
    z_mask, z_body = _apply_map(
        crs, pk_mask, pk_body, proof.z_r, proof.z_m, proof.z_e
    )
    with np.errstate(over="ignore"):
        t_mask = z_mask - c * s_mask[None]
        t_body = z_body - c * s_body[None]
    expect = _transcript_hash(
        crs, pk_digest(pke_pk), lst, aux_data, t_mask, t_body
    )
    if not secrets.compare_digest(expect, proof.challenge):
        raise ZkProofError("challenge mismatch (wrong statement, auxData or CRS)")

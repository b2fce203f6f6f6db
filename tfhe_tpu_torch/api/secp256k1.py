"""secp256k1 ECDSA with Ethereum-style recoverable signatures.

The reference verifies coprocessor/KMS EIP-712 signatures with ethers'
secp256k1 (reference: sdk/relayer/src/relayer/sendEncryption.ts:384-425
verifyTypedData; publicDecrypt.ts:23-47). This is a from-scratch
host-side implementation (signing a handful of 32-byte digests per input
is protocol work, not device work): Jacobian point arithmetic, RFC 6979
deterministic nonces, low-s normalization (EIP-2), keccak-derived
addresses.
"""

from __future__ import annotations

import hashlib
import hmac

from tfhe_tpu_torch.utils.keccak import keccak256

# curve: y^2 = x^3 + 7 over F_p
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_G = (GX, GY, 1)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


# -- Jacobian point ops (z=0 encodes infinity) ------------------------------


def _dbl(pt):
    x, y, z = pt
    if z == 0 or y == 0:
        return (0, 1, 0)
    s = 4 * x * y % P * y % P
    m = 3 * x * x % P  # a = 0
    x2 = (m * m - 2 * s) % P
    y2 = (m * (s - x2) - 8 * pow(y, 4, P)) % P
    z2 = 2 * y * z % P
    return (x2, y2, z2)


def _add(p1, p2):
    if p1[2] == 0:
        return p2
    if p2[2] == 0:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    zz1, zz2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * zz2 % P, x2 * zz1 % P
    s1, s2 = y1 * zz2 % P * z2 % P, y2 * zz1 % P * z1 % P
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return _dbl(p1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hh = h * h % P
    hhh = hh * h % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    z3 = h * z1 % P * z2 % P
    return (x3, y3, z3)


def _native():
    """The C scalar-mult core (native/native.c), cross-checked against
    this module's ladder in tests; None when no compiler is available."""
    from tfhe_tpu_torch import native

    return native if native.ec_available() else None


def _mul(pt, k: int):
    k %= N
    nat = _native()
    if nat is not None:
        return nat.ec_mul(pt, k)
    acc = (0, 1, 0)
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _dbl(pt)
        k >>= 1
    return acc


# Fixed-base 4-bit window table: _BASE_TAB[w][d] = (d << 4w) * G.
# Base-point multiplication (every sign, every address derivation, half
# of every recover) drops from 256 doublings + ~128 adds to ~63 adds.
_BASE_TAB: list | None = None


def _build_base_tab():
    tab = []
    pt = _G
    for _ in range(64):
        row = [(0, 1, 0), pt]
        for _ in range(14):
            row.append(_add(row[-1], pt))
        tab.append(row)
        pt = _dbl(_dbl(_dbl(_dbl(pt))))
    return tab


def _mul_base(k: int):
    """k * G via the fixed-base window table."""
    nat = _native()
    if nat is not None:
        return nat.ec_mul(_G, k % N)
    global _BASE_TAB
    if _BASE_TAB is None:
        _BASE_TAB = _build_base_tab()
    k %= N
    acc = (0, 1, 0)
    w = 0
    while k:
        d = k & 15
        if d:
            acc = _add(acc, _BASE_TAB[w][d])
        k >>= 4
        w += 1
    return acc


def _mul_shamir(p1, k1: int, k2: int):
    """k1 * p1 + k2 * G with one shared doubling chain (Strauss-Shamir:
    the verification/recovery combination u1*R + u2*G runs one 256-step
    ladder instead of two)."""
    k1 %= N
    k2 %= N
    nat = _native()
    if nat is not None:
        return nat.ec_mul2(p1, k1, _G, k2)
    both = _add(p1, _G)
    acc = (0, 1, 0)
    for i in range(max(k1.bit_length(), k2.bit_length()) - 1, -1, -1):
        acc = _dbl(acc)
        b1 = (k1 >> i) & 1
        b2 = (k2 >> i) & 1
        if b1 and b2:
            acc = _add(acc, both)
        elif b1:
            acc = _add(acc, p1)
        elif b2:
            acc = _add(acc, _G)
    return acc


def _affine(pt):
    x, y, z = pt
    if z == 0:
        raise ValueError("point at infinity")
    nat = _native()
    if nat is not None:
        return nat.ec_affine(pt)
    zi = _inv(z, P)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 % P * zi % P


# -- keys -------------------------------------------------------------------


def pubkey(priv: int) -> tuple[int, int]:
    return _affine(_mul_base(priv))


def address(priv: int) -> str:
    """Ethereum address of a private key: keccak(pub)[12:]."""
    x, y = pubkey(priv)
    h = keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
    return "0x" + h[12:].hex()


def keygen(seed: bytes) -> int:
    """Deterministic private key from seed material (test/dev quorums)."""
    k = int.from_bytes(keccak256(b"secp256k1-key" + seed), "big") % N
    return k or 1


# -- RFC 6979 deterministic nonce ------------------------------------------


def _rfc6979_k(priv: int, digest: bytes) -> int:
    holen = 32
    x = priv.to_bytes(32, "big")
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + digest, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + digest, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# -- sign / verify / recover ------------------------------------------------


def sign(priv: int, digest: bytes) -> bytes:
    """65-byte Ethereum signature r(32) || s(32) || v(1), low-s, v in
    {27, 28}."""
    assert len(digest) == 32
    z = int.from_bytes(digest, "big")
    while True:
        k = _rfc6979_k(priv, digest)
        x, y = _affine(_mul_base(k))
        r = x % N
        if r == 0:
            digest = keccak256(digest)
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            digest = keccak256(digest)
            continue
        rec = (1 if y & 1 else 0) | (2 if x >= N else 0)
        if s > N // 2:  # EIP-2 low-s
            s = N - s
            rec ^= 1
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([27 + rec])


def recover(digest: bytes, sig: bytes) -> tuple[int, int]:
    """Recover the signing public key from a 65-byte signature."""
    assert len(sig) == 65
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    v = sig[64]
    if v >= 27:
        v -= 27
    if not (1 <= r < N and 1 <= s < N and v < 4):
        raise ValueError("bad signature")
    x = r + (N if v & 2 else 0)
    if x >= P:
        raise ValueError("bad signature")
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("not a curve point")
    if (y & 1) != (v & 1):
        y = P - y
    z = int.from_bytes(digest, "big")
    rinv = _inv(r, N)
    # Q = r^-1 (s*R - z*G), one Strauss-Shamir ladder
    q = _mul_shamir((x, y, 1), s * rinv % N, (-z) * rinv % N)
    return _affine(q)


def recover_address(digest: bytes, sig: bytes) -> str:
    x, y = recover(digest, sig)
    h = keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
    return "0x" + h[12:].hex()


def verify(pub: tuple[int, int], digest: bytes, sig: bytes) -> bool:
    try:
        return recover(digest, sig) == pub
    except ValueError:
        return False

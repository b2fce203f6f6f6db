"""ML-KEM-512 (FIPS 203): the post-quantum user keypair for re-encryption.

The reference's user-decrypt flow generates an **ML-KEM** keypair on the
client and the KMS parties encrypt their decryption shares to it
(reference: sdk/relayer/src/sdk/keypair.ts:136-144
`TKMS.ml_kem_pke_keygen` / `ml_kem_pke_pk_to_u8vec`, consumed at
relayer/userDecrypt.ts:125-126). This module is a from-scratch numpy
implementation of ML-KEM-512 (keygen / encaps / decaps with implicit
rejection) plus a SHAKE-derived stream cipher so decryption shares can
be wrapped to the user key (`seal_to` / `open_from`).

Not constant-time (Python); the security contract here is correctness
of the algebra and key/ciphertext formats, matching FIPS 203 sizes
(ek 800 B, dk 1632 B, ct 768 B).
"""

from __future__ import annotations

import hashlib
import secrets

import numpy as np

N = 256
Q = 3329
K = 2  # ML-KEM-512
ETA1 = 3
ETA2 = 2
DU = 10
DV = 4

ZETA = 17  # primitive 256th root of unity mod q


def _bitrev7(i: int) -> int:
    return int(f"{i:07b}"[::-1], 2)


_ZETAS = np.array([pow(ZETA, _bitrev7(i), Q) for i in range(128)], dtype=np.int64)
_GAMMAS = np.array(
    [pow(ZETA, 2 * _bitrev7(i) + 1, Q) for i in range(128)], dtype=np.int64
)


def _sha3_256(x: bytes) -> bytes:
    return hashlib.sha3_256(x).digest()


def _sha3_512(x: bytes) -> bytes:
    return hashlib.sha3_512(x).digest()


def _shake128(x: bytes, n: int) -> bytes:
    return hashlib.shake_128(x).digest(n)


def _shake256(x: bytes, n: int) -> bytes:
    return hashlib.shake_256(x).digest(n)


# -- polynomial NTT over Z_q (incomplete: 128 degree-2 components) ------------


def ntt(f: np.ndarray) -> np.ndarray:
    f = f.copy().astype(np.int64)
    i = 1
    length = 128
    while length >= 2:
        for start in range(0, N, 2 * length):
            z = _ZETAS[i]
            i += 1
            for j in range(start, start + length):
                t = z * f[j + length] % Q
                f[j + length] = (f[j] - t) % Q
                f[j] = (f[j] + t) % Q
        length //= 2
    return f


def ntt_inv(f: np.ndarray) -> np.ndarray:
    f = f.copy().astype(np.int64)
    i = 127
    length = 2
    while length <= 128:
        for start in range(0, N, 2 * length):
            z = _ZETAS[i]
            i -= 1
            for j in range(start, start + length):
                t = f[j]
                f[j] = (t + f[j + length]) % Q
                f[j + length] = z * (f[j + length] - t) % Q
        length *= 2
    return f * 3303 % Q  # 3303 = 128^-1 mod q


def ntt_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pointwise product of two NTT-domain polys (degree-2 components)."""
    a0, a1 = a[0::2], a[1::2]
    b0, b1 = b[0::2], b[1::2]
    c = np.empty(N, dtype=np.int64)
    c[0::2] = (a0 * b0 + a1 * b1 % Q * _GAMMAS) % Q
    c[1::2] = (a0 * b1 + a1 * b0) % Q
    return c


# -- samplers -------------------------------------------------------------------


def _sample_ntt(seed: bytes) -> np.ndarray:
    """Uniform NTT-domain poly by rejection from SHAKE128 (FIPS 203 Alg 7)."""
    out = np.empty(N, dtype=np.int64)
    got = 0
    stream = hashlib.shake_128(seed)
    buf = stream.digest(3 * N)
    pos = 0
    while got < N:
        if pos + 3 > len(buf):
            buf = stream.digest(2 * len(buf))
        b0, b1, b2 = buf[pos], buf[pos + 1], buf[pos + 2]
        pos += 3
        d1 = b0 + 256 * (b1 % 16)
        d2 = b1 // 16 + 16 * b2
        if d1 < Q:
            out[got] = d1
            got += 1
        if d2 < Q and got < N:
            out[got] = d2
            got += 1
    return out


def _cbd(buf: bytes, eta: int) -> np.ndarray:
    """Centered binomial from 64*eta bytes (FIPS 203 Alg 8)."""
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8), bitorder="little")
    bits = bits.reshape(N, 2 * eta).astype(np.int64)
    return (bits[:, :eta].sum(1) - bits[:, eta:].sum(1)) % Q


def _prf(eta: int, s: bytes, b: int) -> bytes:
    return _shake256(s + bytes([b]), 64 * eta)


# -- byte codecs ------------------------------------------------------------------


def _byte_encode(f: np.ndarray, d: int) -> bytes:
    m = 2**d
    vals = np.asarray(f, dtype=np.int64) % (Q if d == 12 else m)
    bits = ((vals[:, None] >> np.arange(d)[None, :]) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _byte_decode(b: bytes, d: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(b, dtype=np.uint8), bitorder="little")
    bits = bits[: N * d].reshape(N, d).astype(np.int64)
    return (bits * (1 << np.arange(d))[None, :]).sum(1)


def _compress(x: np.ndarray, d: int) -> np.ndarray:
    return ((x.astype(np.int64) * (1 << d) + Q // 2) // Q) % (1 << d)


def _decompress(y: np.ndarray, d: int) -> np.ndarray:
    return (y.astype(np.int64) * Q + (1 << (d - 1))) >> d


# -- K-PKE ---------------------------------------------------------------------------


def _kpke_keygen(d: bytes):
    g = _sha3_512(d + bytes([K]))
    rho, sigma = g[:32], g[32:]
    a = [[_sample_ntt(rho + bytes([j, i])) for j in range(K)] for i in range(K)]
    nonce = 0
    s = []
    e = []
    for _ in range(K):
        s.append(ntt(_cbd(_prf(ETA1, sigma, nonce), ETA1)))
        nonce += 1
    for _ in range(K):
        e.append(ntt(_cbd(_prf(ETA1, sigma, nonce), ETA1)))
        nonce += 1
    t = [
        (sum(ntt_mul(a[i][j], s[j]) for j in range(K)) + e[i]) % Q
        for i in range(K)
    ]
    ek = b"".join(_byte_encode(ti, 12) for ti in t) + rho
    dk = b"".join(_byte_encode(si, 12) for si in s)
    return ek, dk


def _kpke_encrypt(ek: bytes, m: bytes, r: bytes) -> bytes:
    t = [_byte_decode(ek[384 * i : 384 * (i + 1)], 12) for i in range(K)]
    rho = ek[384 * K :]
    a = [[_sample_ntt(rho + bytes([j, i])) for j in range(K)] for i in range(K)]
    nonce = 0
    y = []
    for _ in range(K):
        y.append(ntt(_cbd(_prf(ETA1, r, nonce), ETA1)))
        nonce += 1
    e1 = []
    for _ in range(K):
        e1.append(_cbd(_prf(ETA2, r, nonce), ETA2))
        nonce += 1
    e2 = _cbd(_prf(ETA2, r, nonce), ETA2)
    u = [
        (ntt_inv(sum(ntt_mul(a[j][i], y[j]) for j in range(K)) % Q) + e1[i]) % Q
        for i in range(K)
    ]
    mu = _decompress(
        np.unpackbits(np.frombuffer(m, np.uint8), bitorder="little").astype(np.int64),
        1,
    )
    v = (ntt_inv(sum(ntt_mul(t[j], y[j]) for j in range(K)) % Q) + e2 + mu) % Q
    c1 = b"".join(
        _byte_encode(_compress(ui, DU), DU)[: 32 * DU] for ui in u
    )
    c2 = _byte_encode(_compress(v, DV), DV)[: 32 * DV]
    return c1 + c2


def _kpke_decrypt(dk: bytes, c: bytes) -> bytes:
    step = 32 * DU
    u = [
        _decompress(_byte_decode(c[step * i : step * (i + 1)], DU), DU)
        for i in range(K)
    ]
    v = _decompress(_byte_decode(c[step * K :], DV), DV)
    s = [_byte_decode(dk[384 * i : 384 * (i + 1)], 12) for i in range(K)]
    w = (v - ntt_inv(sum(ntt_mul(s[j], ntt(u[j])) for j in range(K)) % Q)) % Q
    bits = _compress(w, 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


# -- ML-KEM (FIPS 203) ------------------------------------------------------------------


def keygen(seed: bytes | None = None) -> tuple[bytes, bytes]:
    """Returns (ek, dk): encapsulation key 800 B, decapsulation key 1632 B."""
    if seed is None:
        d, z = secrets.token_bytes(32), secrets.token_bytes(32)
    else:
        g = _sha3_512(b"tfhe-tpu-mlkem-seed" + seed)
        d, z = g[:32], g[32:]
    ek, dk_pke = _kpke_keygen(d)
    dk = dk_pke + ek + _sha3_256(ek) + z
    return ek, dk


def encaps(ek: bytes, m: bytes | None = None) -> tuple[bytes, bytes]:
    """Returns (shared_secret 32 B, ciphertext 768 B)."""
    if m is None:
        m = secrets.token_bytes(32)
    g = _sha3_512(m + _sha3_256(ek))
    k_sh, r = g[:32], g[32:]
    c = _kpke_encrypt(ek, m, r)
    return k_sh, c


def decaps(dk: bytes, c: bytes) -> bytes:
    """Shared secret, with implicit rejection on malformed ciphertexts."""
    dk_pke = dk[: 384 * K]
    ek = dk[384 * K : 768 * K + 32]
    h = dk[768 * K + 32 : 768 * K + 64]
    z = dk[768 * K + 64 :]
    m2 = _kpke_decrypt(dk_pke, c)
    g = _sha3_512(m2 + h)
    k2, r2 = g[:32], g[32:]
    k_rej = _shake256(z + c, 32)
    c2 = _kpke_encrypt(ek, m2, r2)
    return k2 if c2 == c else k_rej


# -- share wrapping (the KMS-side sealing of decryption shares) ---------------------


def seal_to(ek: bytes, plaintext: bytes) -> bytes:
    """KEM-DEM seal: encapsulate, then SHAKE256 keystream (the role of the
    share encryption in the reference's user-decrypt response)."""
    k_sh, c = encaps(ek)
    stream = _shake256(k_sh + b"dem", len(plaintext))
    ct = bytes(a ^ b for a, b in zip(plaintext, stream))
    tag = _sha3_256(k_sh + ct)[:16]
    return c + tag + ct


def open_from(dk: bytes, sealed: bytes) -> bytes:
    c, tag, ct = sealed[:768], sealed[768:784], sealed[784:]
    k_sh = decaps(dk, c)
    if _sha3_256(k_sh + ct)[:16] != tag:
        raise ValueError("share authentication failed")
    stream = _shake256(k_sh + b"dem", len(ct))
    return bytes(a ^ b for a, b in zip(ct, stream))

"""Native host-runtime layer (C, loaded via ctypes).

The reference keeps its host-native work in Rust (keccak handle hashing,
secp256k1); this package compiles the equivalent C kernels (`native.c`,
the JAX package's source without its bit-pack codec, which the port
keeps in numpy in core/seeded.py and re-exports here as `bitpack` /
`bitunpack`) with `cc` on first use into
`tfhe_tpu_torch/_build/libtfhe_native-<hash>.so` (pybind11 is not
in the base image, hence ctypes), never at import and never beside the
source. Falls back to pure python transparently if no compiler is
available. This is host code: no function here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

from tfhe_tpu_torch.core.seeded import bitpack as bitpack, bitunpack as bitunpack

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native.c")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CFLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_tried = False


def _so_path() -> str:
    """The library's path, named by a hash of the source and flags, so an
    edited source is rebuilt and an unchanged one is reused."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_CFLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libtfhe_native-{h}.so")


def _build() -> str | None:
    so_path = _so_path()
    if os.path.exists(so_path):
        return so_path
    cc = os.environ.get("CC", "cc")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # per-pid temp name (no mktemp TOCTOU): concurrent builders each
    # compile their own file; os.replace makes the install atomic
    fd, tmp = tempfile.mkstemp(
        suffix=f".{os.getpid()}.so", prefix=".libtfhe_native_", dir=_BUILD_DIR
    )
    os.close(fd)
    cmd = [cc, *_CFLAGS, "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.tfhe_keccak256.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def keccak256(data: bytes) -> bytes:
    """Ethereum keccak-256. Native C when available, else the pure-python
    implementation in utils/keccak.py."""
    lib = _load()
    if lib is None:
        from tfhe_tpu_torch.utils.keccak import keccak256_py

        return keccak256_py(data)
    out = ctypes.create_string_buffer(32)
    lib.tfhe_keccak256(data, len(data), out)
    return out.raw


# -- secp256k1 scalar multiplication ------------------------------------------


def _setup_ec(lib):
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tfhe_ec_mul.argtypes = [u64p, u64p, u64p]
    lib.tfhe_ec_mul2.argtypes = [u64p, u64p, u64p, u64p, u64p]
    lib.tfhe_ec_affine.argtypes = [u64p, u64p]
    lib.tfhe_ec_affine.restype = ctypes.c_int
    lib.__ec_ready = True


def _limbs(v: int):
    return (ctypes.c_uint64 * 4)(*[(v >> (64 * i)) & ((1 << 64) - 1)
                                   for i in range(4)])


def _pt_limbs(pt):
    x, y, z = pt
    arr = (ctypes.c_uint64 * 12)()
    for j, v in enumerate((x, y, z)):
        for i in range(4):
            arr[j * 4 + i] = (v >> (64 * i)) & ((1 << 64) - 1)
    return arr


def _pt_from(arr):
    vals = [sum(int(arr[j * 4 + i]) << (64 * i) for i in range(4))
            for j in range(3)]
    return tuple(vals)


def ec_available() -> bool:
    lib = _load()
    if lib is None or not hasattr(lib, "tfhe_ec_mul"):
        return False
    if not getattr(lib, "__ec_ready", False):
        _setup_ec(lib)
    return True


def ec_mul(pt, k: int):
    """k * P over secp256k1, Jacobian (x, y, z) int tuples."""
    lib = _load()
    out = (ctypes.c_uint64 * 12)()
    lib.tfhe_ec_mul(_pt_limbs(pt), _limbs(k), out)
    return _pt_from(out)


def ec_mul2(a, ka: int, b, kb: int):
    """ka * A + kb * B (shared-doubling ladder)."""
    lib = _load()
    out = (ctypes.c_uint64 * 12)()
    lib.tfhe_ec_mul2(_pt_limbs(a), _limbs(ka), _pt_limbs(b), _limbs(kb), out)
    return _pt_from(out)


def ec_affine(pt):
    """Jacobian -> affine (x, y); raises at infinity."""
    lib = _load()
    out = (ctypes.c_uint64 * 8)()
    if not lib.tfhe_ec_affine(_pt_limbs(pt), out):
        raise ValueError("point at infinity")
    x = sum(int(out[i]) << (64 * i) for i in range(4))
    y = sum(int(out[4 + i]) << (64 * i) for i in range(4))
    return x, y

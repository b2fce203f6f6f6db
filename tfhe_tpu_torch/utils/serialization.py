"""Size-capped binary serialization for keys, ciphertexts and results,
wire-identical to tfhe_tpu.utils.serialization.

The reference serializes every crypto object with bincode/safe_serialize
under 512 MiB caps (reference: ml/extensions/rust/src/lib_python.rs:51-168,
sdk/relayer/src/sdk/encrypt.ts:190-193, src/constants.ts:1-3). The
format: JSON header (class names + meta + shapes/dtypes) followed by raw
little-endian array payloads.

Input handles are keccak hashes over these bytes (api/instance.py), so the
port writes exactly the JAX package's blob for the same object:

- each class under the JAX package's `module:qualname` (`tfhe_tpu.api.
  compact_pke:CompactCiphertextList`, ...), and the secret keys, which are
  NamedTuples there, as `__namedtuple__`;
- int64 tensors (u64 torus bits) as `uint64`, int32 tensors (u32 residue
  bits) as `uint32`, every other dtype as numpy names it;
- fields whose name starts with `_` (derived caches such as
  `KeyswitchKey._rhs`) are not written.

Reading maps those names back to the port's classes through the explicit
table `_classes()`, never through an import of a name found in a blob, so a
crafted blob can construct nothing else. Blobs cross between the packages
in both directions.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
from typing import Any

import numpy as np
import torch

from tfhe_tpu_torch import _device

MAX_SERIALIZED_SIZE = 512 * 1024 * 1024  # reference cap (constants.ts:1-3)

_MAGIC = b"TFHETPU1"
# classes that are NamedTuples in the JAX package (core/keys.py)
_NAMEDTUPLES = ("tfhe_tpu.core.keys:GlweSecretKey", "tfhe_tpu.core.keys:LweSecretKey")


class SerializationError(ValueError):
    pass


@functools.cache
def _classes() -> dict:
    """The JAX package's class name -> the port's class, for every class a
    blob may name."""
    from tfhe_tpu_torch import params
    from tfhe_tpu_torch.api import compact_pke, public_key, threshold
    from tfhe_tpu_torch.core import bootstrap, keys, lwe, multibit, packing
    from tfhe_tpu_torch.models import glwe_matmul, integer, shortint

    table = {}
    for mod, names in (
        (params, ("NoiseDistribution", "GadgetParams", "ShortintParams", "BooleanParams", "MatmulParams")),
        (keys, ("GlweSecretKey", "LweSecretKey")),
        (lwe, ("KeyswitchKey",)),
        (bootstrap, ("BootstrapKey",)),
        (multibit, ("MultiBitBootstrapKey",)),
        (packing, ("PackingKeyswitchKey",)),
        (glwe_matmul, ("EncryptedMatrix", "CompressedResultMatrix")),
        (shortint, ("ClientKey", "ServerKey", "Ciphertext")),
        (integer, ("RadixCiphertext",)),
        (public_key, ("CompactPublicKey",)),
        (compact_pke, ("PkeParams", "CompactPkeKeySet", "CompactCiphertextList")),
        (threshold, ("KeyShare",)),
    ):
        ref_mod = "tfhe_tpu" + mod.__name__[len("tfhe_tpu_torch"):]
        for name in names:
            table[f"{ref_mod}:{name}"] = getattr(mod, name)
    return table


def _name_of(cls) -> str:
    for ref, port_cls in _classes().items():
        if port_cls is cls:
            return ref
    raise SerializationError(f"serialize: no wire name for {cls.__module__}:{cls.__qualname__}")


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _meta_of(obj, leaves: list):
    """The header meta of `obj`; its arrays are appended to `leaves` in
    the order the header lists them (fields in declaration order, dict
    keys sorted), the order the JAX package's pytree leaves take."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = _name_of(type(obj))
        d = {}
        for f in dataclasses.fields(obj):
            if f.name.startswith("_"):
                continue
            v = getattr(obj, f.name)
            # as the JAX package: a field recurses only into arrays,
            # dataclasses and tuples; any other value is written as is
            nested = _is_array(v) or isinstance(v, tuple) or dataclasses.is_dataclass(v)
            d[f.name] = _meta_of(v, leaves) if nested else v
        kind = "__namedtuple__" if name in _NAMEDTUPLES else "__dataclass__"
        return {kind: name, "fields": d}
    if isinstance(obj, tuple):
        return {"__tuple__": [_meta_of(x, leaves) for x in obj]}
    if isinstance(obj, dict):
        # str keys only: non-str keys would silently change type on
        # round-trip (and mixed-type keys make sorted() raise)
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("serialize: dict keys must be str")
        return {"__dict__": {k: _meta_of(obj[k], leaves) for k in sorted(obj)}}
    if _is_array(obj):
        leaves.append(obj)
        return {"__array__": True}
    return obj


def _host_array(x) -> np.ndarray:
    """A leaf as the numpy array the JAX package would hold: int64 tensors
    carry u64 bits and int32 tensors u32 bits."""
    if isinstance(x, np.ndarray):
        return x
    a = x.detach().cpu().contiguous().numpy()
    if a.dtype == np.int64:
        return a.view(np.uint64)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a


def serialize(obj: Any, max_size: int = MAX_SERIALIZED_SIZE) -> bytes:
    """Serialize a key, ciphertext or result to the JAX package's bytes."""
    leaves: list = []
    meta = _meta_of(obj, leaves)
    arrays = [_host_array(x) for x in leaves]
    header = {
        "meta": meta,
        "arrays": [{"dtype": str(a.dtype), "shape": list(a.shape)} for a in arrays],
    }
    hb = json.dumps(header, separators=(",", ":")).encode()
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(len(hb).to_bytes(8, "little"))
    buf.write(hb)
    for a in arrays:
        buf.write(np.ascontiguousarray(a).tobytes())
    out = buf.getvalue()
    if len(out) > max_size:
        raise SerializationError(f"serialized size {len(out)} exceeds cap {max_size}")
    return out


def _resolve(qualname: str, table: dict):
    """A serialized class name -> the port's class. Only names in the
    table resolve: the deserializer instantiates cls(**kwargs), so an
    unrestricted lookup would let a crafted blob (network payloads,
    pre-planted cache files) construct arbitrary classes in-process."""
    cls = table.get(qualname)
    if cls is None:
        raise SerializationError(f"refusing to resolve class {qualname!r}")
    return cls


def _rebuild(meta, arrays: list, table: dict):
    if isinstance(meta, dict) and ("__dataclass__" in meta or "__namedtuple__" in meta):
        cls = _resolve(meta.get("__dataclass__") or meta["__namedtuple__"], table)
        return cls(**{k: _rebuild(v, arrays, table) for k, v in meta["fields"].items()})
    if isinstance(meta, dict) and "__tuple__" in meta:
        return tuple(_rebuild(x, arrays, table) for x in meta["__tuple__"])
    if isinstance(meta, dict) and "__dict__" in meta:
        return {k: _rebuild(v, arrays, table) for k, v in meta["__dict__"].items()}
    if isinstance(meta, dict) and meta.get("__array__"):
        return arrays.pop(0)
    if isinstance(meta, list):  # JSON turned tuples into lists
        return tuple(meta)
    return meta


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    elif arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def deserialize(data: bytes, max_size: int = MAX_SERIALIZED_SIZE, device=None) -> Any:
    """safe_deserialize analog: size cap + format validation. Arrays come
    back as tensors on `device` (default "cuda"): uint64 as int64 bits,
    uint32 as int32 bits."""
    dev = _device.resolve(device)
    if len(data) > max_size:
        raise SerializationError(f"input size {len(data)} exceeds cap {max_size}")
    if data[:8] != _MAGIC:
        raise SerializationError("bad magic")
    hlen = int.from_bytes(data[8:16], "little")
    header = json.loads(data[16 : 16 + hlen])
    off = 16 + hlen
    arrays = []
    for spec in header["arrays"]:
        dt = np.dtype(spec["dtype"])
        count = int(np.prod(spec["shape"])) if spec["shape"] else 1
        nbytes = dt.itemsize * count
        if off + nbytes > len(data):
            raise SerializationError("truncated payload")
        arr = np.frombuffer(data[off : off + nbytes], dtype=dt).reshape(spec["shape"])
        arrays.append(_to_tensor(arr, dev))
        off += nbytes
    return _rebuild(header["meta"], arrays, _classes())

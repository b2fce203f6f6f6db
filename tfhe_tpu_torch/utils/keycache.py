"""Warm-start key cache: serialized (ClientKey, ServerKey) on disk
(counterpart of tfhe_tpu/utils/keycache.py: the same cache key, file
name and blob format, written through the port's serializer).

tfhe-rs keygen takes seconds and keys are routinely serialized and
reloaded (reference: the SDK fetches pre-generated server keys over
/keyurl, sdk/relayer/src/tfhe.ts:13-33; the coprocessor never
regenerates keys per process). This module caches the key pair on disk
keyed by (params hash, seed, group) and `load_or_keygen` turns a later
process start into a deserialize + host->device copy.

The cache trusts its directory (keys include the SECRET key client
half); it is a single-host warm-start, not a distribution channel —
the serving layer's /keyurl path stays the way EVALUATION keys travel.

Device policy, the JAX package's backend rule: the disk path is only a
win where keygen is slower than reading the blob. On the card, keygen
from the seed is the faster warm start (GROUP_3 keys take under a second
to generate on an H100 and are ~2.4 GB serialized), so `load_or_keygen`
neither reads nor writes the disk there; on the CPU it does.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any

import torch

from tfhe_tpu_torch import _device

# multibit GROUP_3 server keys are ~2.4 GB serialized — far over the
# protocol's 512 MiB wire cap, which exists for untrusted *network*
# payloads (utils/serialization.py), not for this trusted local cache.
KEY_CACHE_MAX = 8 * 1024 * 1024 * 1024


def default_dir() -> str:
    """TFHE_TPU_KEY_CACHE_DIR, else `.cache/torch_keys` in the checkout when
    it is writable, else a directory under the process's temp dir. Not the
    JAX package's `.cache/keys`: the two packages draw the same keys from
    one seed, but each writes its own file format."""
    env = os.environ.get("TFHE_TPU_KEY_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if os.access(root, os.W_OK):
        return os.path.join(root, ".cache", "torch_keys")
    return os.path.join(tempfile.gettempdir(), "tfhe_tpu_torch_keys")


DEFAULT_DIR = default_dir()  # the JAX package's name; callers read default_dir() at call time


def _effective_group(params, multibit_group: int | None) -> int:
    """Mirror si.keygen's inference: MULTI_BIT_GROUP_N param sets imply
    their group; the cache key must agree no matter how callers spell it."""
    if multibit_group is not None:
        return multibit_group
    name = getattr(params, "name", "")
    if "MULTI_BIT_GROUP_" in name:
        return int(name.split("MULTI_BIT_GROUP_")[1].split("_")[0])
    return 0


def cache_path(params, seed: int, multibit_group: int | None, cache_dir: str | None = None) -> str:
    """The JAX package's file name for the same keys. The NTT-domain key
    material depends on the process's CRT prime set, so a 4-prime process
    (TFHE_TPU_PRIMES=4) tags its files `_p4` and never loads 3-prime keys."""
    from tfhe_tpu_torch.ops.folded_ntt import DEFAULT_PRIMES

    d = cache_dir or default_dir()
    g = _effective_group(params, multibit_group)
    ptag = f"_p{len(DEFAULT_PRIMES)}" if len(DEFAULT_PRIMES) != 3 else ""
    return os.path.join(d, f"{params.hash[:16]}_s{seed}_g{g}{ptag}.tfhekeys")


def save_keys(path: str, ck, sk) -> None:
    from tfhe_tpu_torch.utils.serialization import serialize

    # owner-only: the blob contains the SECRET client key
    os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
    try:
        os.chmod(os.path.dirname(path), 0o700)
    except OSError:
        pass
    blob = serialize((ck, sk), max_size=KEY_CACHE_MAX)
    tmp = path + f".tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # atomic: concurrent writers never tear


def load_keys(path: str, device=None):
    from tfhe_tpu_torch.utils.serialization import deserialize

    with open(path, "rb") as f:
        return deserialize(f.read(), max_size=KEY_CACHE_MAX, device=device)


def _disk_cache_pays_off(device: torch.device) -> bool:
    """TFHE_TPU_KEY_CACHE overrides: 0 = never touch disk, force = always
    use disk; otherwise the disk is used on the CPU and skipped on the
    card (see the module docstring)."""
    mode = os.environ.get("TFHE_TPU_KEY_CACHE", "1")
    if mode == "force":
        return True
    return device.type != "cuda"


def load_or_keygen(
    params, seed: int = 0, multibit_group: int | None = None, cache_dir: str | None = None, device=None
) -> tuple[Any, Any, dict]:
    """(ck, sk, info): cached keys when present, else keygen + store, on
    `device` (default "cuda").

    info = {"hit": bool, "seconds": wall time of whichever path ran,
    "path": the cache file}. With TFHE_TPU_KEY_CACHE=0, and on the card
    unless it is "force", nothing is read or written (hit=False)."""
    from tfhe_tpu_torch.models import shortint as si

    dev = _device.resolve(device)
    enabled = os.environ.get("TFHE_TPU_KEY_CACHE", "1") != "0" and _disk_cache_pays_off(dev)
    path = cache_path(params, seed, multibit_group, cache_dir)
    if enabled and os.path.exists(path):
        t0 = time.time()
        try:
            ck, sk = load_keys(path, device=dev)
        except (OSError, ValueError, KeyError, TypeError):  # SerializationError is a ValueError
            # corrupt / truncated / older-format entry: regenerate and
            # overwrite rather than failing every process start forever
            pass
        else:
            return ck, sk, {"hit": True, "seconds": time.time() - t0, "path": path}
    t0 = time.time()
    ck, sk = si.keygen(params, seed=seed, multibit_group=multibit_group, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the measured time covers the device work
    dt = time.time() - t0
    if enabled:
        save_keys(path, ck, sk)
    return ck, sk, {"hit": False, "seconds": dt, "path": path}

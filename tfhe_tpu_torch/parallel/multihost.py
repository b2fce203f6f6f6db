"""Multi-host execution: the host axis of the distributed PBS
(counterpart of tfhe_tpu/parallel/multihost.py).

    mesh = ("host", "data", "model")
      host  -- one entry per host (a machine of `ranks_per_host` ranks).
               The ciphertext batch is split over host x data, so no
               per-step collective crosses a host: host-axis traffic is
               the one-time key placement, which costs nothing because
               every rank builds the same keys from one seed.
      data  -- batch parallelism inside a host (no communication).
      model -- intra-PBS sharding (KSK input dim + GGSW rows) whose
               all-reduces stay inside a host, "model" being the
               innermost axis.

torch has no global array and no ordering of devices by process, so:
  * "host" comes from `ranks_per_host` (default LOCAL_WORLD_SIZE): ranks
    h * ranks_per_host ... (h + 1) * ranks_per_host - 1 form host h;
  * `global_put`, `replicate_batch_global`, `replicate_global` and
    `shard_batch_global` return this rank's local shard on its device,
    the part of JAX's global array this rank's device would hold;
  * `collective_stats` reads the mesh's Recorder (parallel/_comm.py),
    which every collective of the step goes through, where JAX parses
    the compiled HLO. JAX's `_shape_bytes` and `_replica_groups` parse HLO
    text only and have no counterpart.

`parallel/launch.py` spawns a world of ranks on a loopback port (the
counterpart of scripts/multihost_dryrun.py's launcher).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from tfhe_tpu_torch.parallel.mesh import Mesh, build_mesh
from tfhe_tpu_torch.parallel.sharded import make_sharded_pbs_step


def initialize(coordinator_address: str, num_processes: int, process_id: int, backend: str = "nccl"):
    """init_process_group over tcp://coordinator_address (idempotent: returns
    if this process already has a default group). NCCL where every rank
    has a card of its own, gloo for the CPU or ranks sharing a card; a
    backend that fails to initialise raises."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def _ranks_per_host(ranks_per_host: int | None) -> int:
    if ranks_per_host is None:
        if "LOCAL_WORLD_SIZE" not in os.environ:
            raise ValueError("pass ranks_per_host or set LOCAL_WORLD_SIZE")
        ranks_per_host = int(os.environ["LOCAL_WORLD_SIZE"])
    world = dist.get_world_size()
    if ranks_per_host < 1 or world % ranks_per_host:
        raise ValueError(f"{world} ranks do not lay out as hosts of {ranks_per_host}")
    return ranks_per_host


def make_host_mesh(n_model: int = 1, ranks_per_host: int | None = None, device=None) -> Mesh:
    """("host", "data", "model") mesh: each host's ranks form one host
    row, split into data x model, so "model" groups stay inside a host."""
    local = _ranks_per_host(ranks_per_host)
    world = dist.get_world_size()
    if local % n_model:
        raise ValueError(f"{local} ranks per host do not split into model groups of {n_model}")
    grid = np.arange(world).reshape(world // local, local // n_model, n_model)
    host_of = tuple(r // local for r in range(world))
    return build_mesh(grid, ("host", "data", "model"), device, host_of)


def make_cross_host_model_mesh(ranks_per_host: int | None = None, device=None) -> Mesh:
    """("data", "model") mesh with the MODEL axis spanning hosts: rank
    [i, h] is host h's i-th rank, so every model group pairs one rank of
    each host and the per-step all-reduces over "model" cross hosts on
    every step. For keys too big for one host; for throughput prefer
    make_host_mesh (batch over hosts, no per-step traffic between them)."""
    local = _ranks_per_host(ranks_per_host)
    world = dist.get_world_size()
    grid = np.arange(world).reshape(world // local, local).T  # (local, host)
    host_of = tuple(r // local for r in range(world))
    return build_mesh(grid, ("data", "model"), device, host_of)


def global_put(mesh: Mesh, spec, x) -> torch.Tensor:
    """This rank's shard of a value every rank holds whole. spec names,
    per leading dim, the mesh axis (or tuple of axes) that dim is split
    over, or None (JAX's PartitionSpec); the value goes to the mesh's
    device. Placement moves no bytes between ranks."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    for dim, axes in enumerate(spec):
        if axes is not None:
            t = mesh.local_block(t, dim, axes)
    return t.contiguous().to(mesh.device)


def replicate_batch_global(mesh: Mesh, batch) -> torch.Tensor:
    """This rank's rows of a batch every rank holds whole, split over
    "data" (the model ranks of one data row hold the same rows)."""
    return global_put(mesh, ("data",), batch)


def replicate_global(mesh: Mesh, tree):
    """Values every rank holds whole, on the mesh's device, unsplit (keys
    from one seed: no bytes sent). Maps over tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: replicate_global(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate_global(mesh, v) for v in tree)
    return global_put(mesh, (), tree)


def shard_batch_global(mesh: Mesh, local_batch, n_model_axes: int = 0) -> torch.Tensor:
    """This rank's rows of its host's batch `local_batch`. Each host
    contributes its own rows, which its ranks split over "data" (JAX: the
    process-local batch of a ("host", "data")-sharded global array; the
    global batch is the host-order concatenation). `n_model_axes` is
    accepted and unused, as in the JAX package."""
    return global_put(mesh, ("data",), local_batch)


def make_multihost_pbs_step(mesh: Mesh, engine, ks_gadget, pbs_gadget, bsk_shift: int):
    """The distributed PBS step on a ("host", "data", "model") mesh: the
    math of parallel.sharded.make_sharded_pbs_step (KSK over its input
    dim, BSK over GGSW rows, all-reduce over "model") with the batch split
    over host and data. The model groups stay inside one host
    (`collective_stats` shows it)."""
    return make_sharded_pbs_step(mesh, engine, ks_gadget, pbs_gadget, bsk_shift=bsk_shift)


def collective_stats(mesh: Mesh) -> list[dict]:
    """The collectives this rank ran on `mesh` since its recorder was last
    reset, one dict per distinct call: op (JAX's names: "all-reduce",
    "reduce-scatter", "collective-permute"; "broadcast"), bytes (the
    payload this rank hands it), replica_groups (the group's global
    ranks), crosses_host (its ranks span more than one host), count,
    staged (through host memory) and seconds (when the recorder is
    timed). The traffic between hosts is the sum of bytes x count over
    entries with crosses_host."""
    out = []
    for e in mesh.recorder.entries():
        hosts = {mesh.host_of[r] for r in e["ranks"]}
        out.append(dict(op=e["op"], bytes=e["bytes"], replica_groups=[e["ranks"]], crosses_host=len(hosts) > 1,
                        count=e["count"], staged=e["staged"], seconds=e["seconds"]))
    return out

"""Spawn a `torch.distributed` world on one machine and run jobs on it
(the port's counterpart of scripts/multihost_dryrun.py's launcher and
worker modes).

`launch(target, world, args)` starts `world` processes (the "spawn"
start method), joins them into one process group over a loopback port
and runs target(ctx, *args) in each, one intra-op thread per rank; it
returns each rank's picklable result in rank order, and raises (after
stopping every process) if a rank fails or the time runs out. The
backend is NCCL where every rank has a card of its own, gloo on the CPU
or where ranks share a card (NCCL refuses two ranks on one device).

`run_jobs(ctx, jobs)` is the worker: a list of (name, kwargs) run in
order in one world, sharing keys built on each rank from the seed (since
the port's FheRng is the JAX package's threefry stream, every rank holds
the same keys with no bytes sent). The jobs:

  pbs     the sharded PBS step on a ("data", "model") mesh, a host mesh
          ("host", "data", "model"; multihost.make_host_mesh) or the
          cross-host model mesh, on this rank's shards of a batch;
  ntt     make_sharded_ntt forward and inverse of one polynomial;
  rotate  make_key_sharded_blind_rotate over the whole world.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RankContext:
    rank: int
    world: int
    device: torch.device
    backend: str


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(world: int, device=None) -> str:
    """gloo on the CPU or when the ranks outnumber the cards, else NCCL."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _child(target, args, rank, world, addr, backend, device, ranks_per_host, results):
    from tfhe_tpu_torch.parallel.mesh import rank_device
    from tfhe_tpu_torch.parallel.multihost import initialize

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % ranks_per_host),
                      LOCAL_WORLD_SIZE=str(ranks_per_host))
    torch.set_num_threads(1)
    try:
        dev = rank_device(device)
        initialize(addr, world, rank, backend)
        results.put((rank, True, target(RankContext(rank, world, dev, backend), *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(target, world: int, args=(), *, backend: str | None = None, device=None,
           ranks_per_host: int | None = None, timeout: float = 600.0) -> list:
    """Run target(ctx, *args) on `world` spawned ranks; their results in
    rank order. `target` must be importable (pickled by name); `device`
    "cpu" puts every rank on the CPU, None on cuda:{local_rank % cards}.
    ranks_per_host (default: the world) sets LOCAL_RANK and
    LOCAL_WORLD_SIZE, the host layout multihost.make_host_mesh reads."""
    import multiprocessing as mp

    if backend is None:
        backend = default_backend(world, device)
    ranks_per_host = world if ranks_per_host is None else ranks_per_host
    addr = f"127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_child, daemon=True,
                    args=(target, args, r, world, addr, backend, device, ranks_per_host, results))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    done, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s (done: {sorted(done)})")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                lost = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in done]
                if lost:
                    raise RuntimeError(f"ranks {lost} exited with codes {[procs[r].exitcode for r in lost]}")
                continue
            (done if ok else errors)[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(errors.items())))
    return [done[r] for r in range(world)]


# -- the worker ---------------------------------------------------------------


def _keys(ctx: RankContext, state: dict, params, seed: int):
    from tfhe_tpu_torch.models import shortint as si

    key = (params.name, seed)
    if key not in state:
        state[key] = si.keygen(params, seed=seed, device=ctx.device)
    return state[key]


def _launches() -> dict:
    from tfhe_tpu_torch.ops import ntt_cuda

    return {"K1": ntt_cuda.forward.launches, "K2": ntt_cuda.inverse.launches}


def _sync(ctx: RankContext):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.int64).view(np.uint64)


def _tensor(a, ctx: RankContext) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)).to(ctx.device)


def pbs_job(ctx: RankContext, state: dict, params, seed: int, cts, lut_table, layout: str = "mesh",
            n_data: int | None = None, n_model: int = 1, ranks_per_host: int | None = None,
            timed_runs: int = 0) -> dict:
    """The sharded PBS step on this rank's shards of `cts` (the whole
    batch, (B, kN+1) uint64) through lut_table, on a mesh of `layout`:
    "mesh" (make_mesh(n_data, n_model)), "host" (make_host_mesh(n_model,
    ranks_per_host)) or "cross" (make_cross_host_model_mesh). One counted
    run (its collectives and K1/K2 launches), then `timed_runs` timed
    runs and one with the recorder timed."""
    from tfhe_tpu_torch.models import shortint as si
    from tfhe_tpu_torch.parallel import multihost as mh
    from tfhe_tpu_torch.parallel.mesh import make_mesh
    from tfhe_tpu_torch.parallel.sharded import make_sharded_pbs_step, shard_inputs

    _, sk = _keys(ctx, state, params, seed)
    if layout == "mesh":
        mesh, batch_axes = make_mesh(n_data, n_model, device=ctx.device), ("data",)
    elif layout == "host":
        mesh, batch_axes = mh.make_host_mesh(n_model, ranks_per_host, device=ctx.device), ("host", "data")
    elif layout == "cross":
        mesh, batch_axes = mh.make_cross_host_model_mesh(ranks_per_host, device=ctx.device), ("data",)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    engine = si.engine_for(params, ctx.device)
    lut = si.generate_lut(params, np.asarray(lut_table, dtype=np.uint64), ctx.device)
    whole = _tensor(cts, ctx)
    c_loc, bsk_loc, ksk_loc = shard_inputs(mesh, whole, sk.bsk.bsk_ntt, sk.ksk.ksk, batch_axes)
    if layout == "host":  # the host's rows, split over its data ranks
        c_loc = mh.shard_batch_global(mesh, mesh.local_block(whole, 0, "host"))
    idx, count = mesh.block_index(batch_axes)
    rows = whole.shape[0] // count
    step = (mh.make_multihost_pbs_step if layout == "host" else make_sharded_pbs_step)(
        mesh, engine, params.ks, params.pbs, bsk_shift=sk.bsk.shift)
    mesh.recorder.reset()
    before = _launches()
    out = step(c_loc, lut, bsk_loc, ksk_loc)
    _sync(ctx)
    after = _launches()
    res = dict(layout=layout, shape=mesh.shape, coords=mesh.coords, rows=(idx * rows, (idx + 1) * rows),
               lines={ax: mesh.line(ax) for ax in mesh.axis_names}, host_of=mesh.host_of,
               out=_u64(out), stats=mh.collective_stats(mesh),
               launches={k: after[k] - before[k] for k in after}, ms=[], timed_stats=None)
    for _ in range(timed_runs):
        _sync(ctx)
        t0 = time.perf_counter()
        again = step(c_loc, lut, bsk_loc, ksk_loc)
        _sync(ctx)
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(again, out):
            raise RuntimeError("a timed run of the sharded step differs from the counted one")
    if timed_runs:
        mesh.recorder.reset()
        mesh.recorder.timed = True
        _sync(ctx)
        t0 = time.perf_counter()
        step(c_loc, lut, bsk_loc, ksk_loc)
        _sync(ctx)
        res["recorder_timed_ms"] = (time.perf_counter() - t0) * 1e3
        res["timed_stats"] = mh.collective_stats(mesh)
        mesh.recorder.timed = False
    return res


def ntt_job(ctx: RankContext, state: dict, n_poly: int, x) -> dict:
    """make_sharded_ntt over the whole world on this rank's C-block of x
    ((N,) uint64): its forward (t-block residues) and the inverse of
    that forward (its C-block of x mod each prime)."""
    from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
    from tfhe_tpu_torch.parallel.mesh import make_mesh
    from tfhe_tpu_torch.parallel.multihost import collective_stats
    from tfhe_tpu_torch.parallel.ntt_sharded import make_sharded_ntt

    engine = get_folded_engine(n_poly, ctx.device)
    mesh = make_mesh(1, ctx.world, device=ctx.device)
    fwd, inv = make_sharded_ntt(engine, mesh)
    x_loc = mesh.local_block(_tensor(x, ctx), 0, "model")
    f = fwd(x_loc)
    back = inv(f)
    return dict(coord=mesh.coord("model"), f=f.cpu().numpy(), back=back.cpu().numpy(),
                stats=collective_stats(mesh))


def rotate_job(ctx: RankContext, state: dict, params, seed: int, small_cts, lut_table) -> dict:
    """make_key_sharded_blind_rotate over the whole world: this rank's
    steps of the BSK, the whole batch of small-key ciphertexts
    ((B, n+1) uint64); the rotated accumulators (B, k+1, N)."""
    from tfhe_tpu_torch.models import shortint as si
    from tfhe_tpu_torch.parallel.mesh import make_mesh
    from tfhe_tpu_torch.parallel.multihost import collective_stats
    from tfhe_tpu_torch.parallel.ntt_sharded import make_key_sharded_blind_rotate

    _, sk = _keys(ctx, state, params, seed)
    mesh = make_mesh(1, ctx.world, device=ctx.device)
    bsk_loc = mesh.local_block(sk.bsk.bsk_ntt, 0, "model").contiguous()
    engine = si.engine_for(params, ctx.device)
    rotate = make_key_sharded_blind_rotate(engine, sk.bsk.gadget, mesh, shift=sk.bsk.shift)
    lut = si.generate_lut(params, np.asarray(lut_table, dtype=np.uint64), ctx.device)
    before = _launches()
    acc = rotate(lut, _tensor(small_cts, ctx), bsk_loc)
    _sync(ctx)
    after = _launches()
    return dict(coord=mesh.coord("model"), acc=_u64(acc), launches={k: after[k] - before[k] for k in after},
                stats=collective_stats(mesh))


JOBS = {"pbs": pbs_job, "ntt": ntt_job, "rotate": rotate_job}


def run_jobs(ctx: RankContext, jobs) -> list:
    """Run each (name, kwargs) of `jobs` in order on this rank; the list of
    their results."""
    state = {}
    return [JOBS[name](ctx, state, **kw) for name, kw in jobs]

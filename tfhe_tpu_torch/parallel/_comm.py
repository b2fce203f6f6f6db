"""The collective layer of `parallel/`: every collective the sharded
modules run goes through these four functions and is recorded.

Each function takes a Mesh and the name of one of its axes and runs over
the process group of this rank's line along that axis:

  all_reduce_sum      -- lax.psum            ("all-reduce")
  reduce_scatter_sum  -- lax.psum_scatter    ("reduce-scatter", tiled on dim 0)
  ring_hop            -- lax.ppermute d -> d+1 ("collective-permute")
  broadcast           -- from coordinate 0 of the axis ("broadcast")

Sums are taken in the tensor's own dtype, two's-complement: an int64 sum
wraps mod 2^64 and an int32 sum mod 2^32, which is JAX's psum on uint64
and uint32 bit for bit.

gloo takes CUDA tensors for all-reduce and broadcast only. For the other
ops on a CUDA tensor in a gloo group the tensor is staged through host
memory, for that op alone; the record says so (`staged`). NCCL takes
every op on the card. There is no fallback: a collective that fails
raises.

A Recorder keeps, per (op, payload bytes, group ranks, staged), the number
of calls and, when `timed` is set, the seconds spent in them (the device
is synchronised around each call, so leave it off outside a measurement).
`multihost.collective_stats` reads it.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

# ops gloo runs on CUDA tensors itself; the rest are staged through the host
GLOO_CUDA_OPS = frozenset({"all-reduce", "broadcast"})


class Recorder:
    """Counts (and, with `timed`, times) the collectives of one mesh."""

    def __init__(self):
        self.timed = False
        self._calls: dict[tuple, list] = {}

    def reset(self) -> None:
        self._calls.clear()

    @contextlib.contextmanager
    def record(self, op: str, x: torch.Tensor, ranks, staged: bool):
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        yield
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        dt = time.perf_counter() - t0 if self.timed else 0.0
        key = (op, x.numel() * x.element_size(), tuple(int(r) for r in ranks), staged)
        entry = self._calls.setdefault(key, [0, 0.0])
        entry[0] += 1
        entry[1] += dt

    def entries(self) -> list[dict]:
        """One dict per distinct collective: op, bytes (the payload this
        rank hands it), ranks (global ranks of the group), staged, count,
        seconds (0 unless timed)."""
        return [
            dict(op=op, bytes=nbytes, ranks=list(ranks), staged=staged, count=c, seconds=s)
            for (op, nbytes, ranks, staged), (c, s) in self._calls.items()
        ]


def _staged(op: str, x: torch.Tensor, group) -> bool:
    return x.is_cuda and op not in GLOO_CUDA_OPS and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of x over the axis, in place; returns x."""
    group, ranks = mesh.group(axis), mesh.line(axis)
    staged = _staged("all-reduce", x, group)
    with mesh.recorder.record("all-reduce", x, ranks, staged):
        buf = x.cpu() if staged else x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if staged:
            x.copy_(buf)
    return x


def reduce_scatter_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of x over the axis, this rank's block of dim 0 (tiled: block i
    of M equal blocks goes to coordinate i)."""
    group, ranks = mesh.group(axis), mesh.line(axis)
    m = len(ranks)
    if x.shape[0] % m:
        raise ValueError(f"reduce-scatter of dim 0 = {x.shape[0]} over {m} ranks")
    x = x.contiguous()
    staged = _staged("reduce-scatter", x, group)
    with mesh.recorder.record("reduce-scatter", x, ranks, staged):
        src = x.cpu() if staged else x
        out = torch.empty((x.shape[0] // m,) + tuple(x.shape[1:]), dtype=x.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
        out = out.to(x.device)
    return out


def ring_hop(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Send x to the next coordinate on the axis and return what the
    previous one sent (lax.ppermute d -> (d + 1) % M). On an axis of one
    rank there is no send to self: x comes back as it is."""
    group, ranks = mesh.group(axis), mesh.line(axis)
    m = len(ranks)
    if m == 1:
        return x
    pos = mesh.coord(axis)
    x = x.contiguous()
    staged = _staged("collective-permute", x, group)
    with mesh.recorder.record("collective-permute", x, ranks, staged):
        src = x.cpu() if staged else x
        buf = torch.empty_like(src)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, ranks[(pos + 1) % m], group),
            dist.P2POp(dist.irecv, buf, ranks[(pos - 1) % m], group),
        ])
        for r in reqs:
            r.wait()
        out = buf.to(x.device)
    return out


def broadcast(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x of coordinate 0 on the axis, on every rank of the line (in place;
    x must be contiguous); returns x."""
    group, ranks = mesh.group(axis), mesh.line(axis)
    staged = _staged("broadcast", x, group)
    with mesh.recorder.record("broadcast", x, ranks, staged):
        buf = x.cpu() if staged else x
        dist.broadcast(buf, src=ranks[0], group=group)
        if staged:
            x.copy_(buf)
    return x

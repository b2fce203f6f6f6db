"""Process mesh for distributed FHE (counterpart of tfhe_tpu/parallel/mesh.py).

Axes:
  * "data"  -- independent ciphertexts (batch parallelism): no
    communication.
  * "model" -- intra-PBS sharding: the GGSW decomposition rows and the
    keyswitch input dimension are split across ranks and the partial sums
    all-reduced over the axis (parallel/sharded.py).

JAX lays a Mesh over devices of one program; here every rank is a
process of a `torch.distributed` world holding one device, and a Mesh is
a grid of global ranks with one process group per line of the grid along
each axis (a row of "model" groups, a column of "data" groups). Every
rank creates every group, in the same order, as `dist.new_group`
requires. The collectives over an axis are in parallel/_comm.py and are
recorded in the mesh's Recorder.

On several hosts "data" (and "host", multihost.py) should span the hosts
and "model" stay inside one.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from tfhe_tpu_torch import _device
from tfhe_tpu_torch.parallel._comm import Recorder


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` if given, else
    cuda:{LOCAL_RANK % device_count}, made the current device (raises
    without a card)."""
    if device is not None:
        return _device.resolve(device)
    _device.resolve("cuda")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    idx = local % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


@dataclasses.dataclass
class Mesh:
    """A grid of global ranks with named axes, seen from one rank.

    grid: int array of global ranks, one dim per axis name.
    coords: this rank's index on each axis (None when the rank is not in
      the grid).
    groups: axis -> the process group of this rank's line along it.
    host_of: global rank -> host index (all 0 on one host).
    """

    grid: np.ndarray
    axis_names: tuple
    rank: int
    device: torch.device
    coords: dict | None
    groups: dict
    host_of: tuple
    recorder: Recorder = dataclasses.field(default_factory=Recorder)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def line(self, axis: str) -> list[int]:
        """Global ranks of this rank's group along `axis`, by coordinate."""
        a = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == a else self.coords[n] for i, n in enumerate(self.axis_names))
        return [int(r) for r in self.grid[idx]]

    def block_index(self, axes) -> tuple[int, int]:
        """(this rank's index, number of blocks) over the axes taken
        together, row-major: the sharding of one dim over ("host",
        "data") in JAX's PartitionSpec."""
        idx, count = 0, 1
        for ax in axes:
            idx = idx * self.size(ax) + self.coord(ax)
            count *= self.size(ax)
        return idx, count

    def local_block(self, x, dim: int, axes):
        """This rank's block of x along `dim`, sharded over `axes`."""
        if isinstance(axes, str):
            axes = (axes,)
        idx, count = self.block_index(axes)
        n = x.shape[dim]
        if n % count:
            raise ValueError(f"dim {dim} of size {n} does not split over {count} ranks of {axes}")
        step = n // count
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(idx * step, (idx + 1) * step)
        return x[tuple(sl)]


def build_mesh(grid: np.ndarray, axis_names: tuple, device=None, host_of=None) -> Mesh:
    """A Mesh over `grid` (global ranks): creates one group per line of
    the grid along each axis, on every rank, in one order."""
    grid = np.asarray(grid, dtype=np.int64)
    if grid.ndim != len(axis_names):
        raise ValueError(f"grid of {grid.ndim} dims for axes {axis_names}")
    rank = dist.get_rank()
    world = dist.get_world_size()
    if len(set(grid.ravel().tolist())) != grid.size or grid.max() >= world:
        raise ValueError(f"grid {grid.tolist()} is not a set of distinct ranks of a world of {world}")
    at = np.argwhere(grid == rank)
    coords = dict(zip(axis_names, (int(c) for c in at[0]))) if len(at) else None
    groups = {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        for line in lines:
            g = dist.new_group(ranks=[int(r) for r in line])
            if rank in line:
                groups[name] = g
    if host_of is None:
        host_of = (0,) * world
    return Mesh(grid=grid, axis_names=tuple(axis_names), rank=rank, device=rank_device(device),
                coords=coords, groups=groups, host_of=tuple(host_of))


def make_mesh(n_data: int | None = None, n_model: int = 1, ranks=None, device=None) -> Mesh:
    """A ("data", "model") mesh over the world's ranks (or `ranks`):
    n_data=None takes world // n_model."""
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    n = len(ranks)
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} ranks do not split into model groups of {n_model}")
        n_data = n // n_model
    if n_data * n_model > n:
        raise ValueError(f"a {n_data} x {n_model} mesh needs more than {n} ranks")
    grid = np.asarray(ranks[: n_data * n_model]).reshape(n_data, n_model)
    return build_mesh(grid, ("data", "model"), device)

"""Device meshes over `torch.distributed` process groups.

The port of `anatomix_tpu/parallel/mesh.py:14-43`. JAX runs one process
over a `Mesh` of devices; PyTorch runs one process per device (`parallel/
launch.spawn`, or `torchrun`), and a mesh is then this rank's place on a
grid of ranks plus one process group along each axis:

- `data_mesh(n)` <- `data_mesh`: a 1-D 'data' mesh over the n ranks;
- `space_mesh(data, space)` <- `space_mesh`: the 2-D ('data', 'space')
  mesh, the innermost axis varying fastest (rank = d * space + s), so a
  spatial shard's neighbours are neighbouring ranks, as JAX keeps them on
  neighbouring devices;
- `shard_batch(mesh, x)` <- `data_sharding`: this rank's contiguous rows
  of a global batch (JAX's `P('data')` places rows the same way);
- `replicate(mesh, tree)` <- `replicate`: every tensor leaf broadcast from
  the mesh's first rank, so all ranks start from one state.

The collectives of the sharded paths are here too: `all_reduce_sum`, which
is autograd-aware (its backward all-reduces the gradient, as JAX's `psum`
transposes to a `psum`), and `group_mean`, the mean of equal shards'
statistics. Every collective that fails raises: nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a grid of ranks: the axis names (outermost
    first), their sizes, this rank's index along each axis and its process
    group along each, and the device its tensors live on."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: tuple[int, ...]
    groups: tuple[Any, ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def axis_size(self, axis: str) -> int:
        return self.sizes[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    def group(self, axis: str):
        """This rank's process group along `axis`."""
        return self.groups[self._axis(axis)]

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no {axis!r} axis (axes: "
                             f"{self.axis_names})")
        return self.axis_names.index(axis)


def _require_world(n: int) -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(parallel.launch.spawn, or initialize_distributed "
                           "under torchrun)")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return dist.get_rank()


def _device_of_rank(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _grid_mesh(names, sizes, device) -> Mesh:
    """Mesh over every rank of the world, row-major in `sizes` (the last
    axis fastest). Every rank creates every group, in the same order, as
    `dist.new_group` requires."""
    n = 1
    for s in sizes:
        n *= s
    rank = _require_world(n)
    coords, r = [], rank
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    groups = []
    for ax, size in enumerate(sizes):
        mine = None
        # one group per setting of the other axes, in rank order
        others = [i for i in range(len(sizes)) if i != ax]
        for flat in range(n // size):
            base, rest = 0, flat
            for i in reversed(others):
                base += (rest % sizes[i]) * strides[i]
                rest //= sizes[i]
            ranks = [base + k * strides[ax] for k in range(size)]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups.append(mine)
    return Mesh(tuple(names), tuple(sizes), coords, tuple(groups),
                _device_of_rank(device))


def data_mesh(n: int | None = None, *, device="cuda") -> Mesh:
    """1-D 'data' mesh over the world's n ranks (all of them by default)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return _grid_mesh(("data",), (n,), device)


def space_mesh(data: int = 1, space: int | None = None, *,
               device="cuda") -> Mesh:
    """2-D ('data', 'space') mesh: batch data parallelism times spatial
    sharding, `data * space` ranks."""
    if space is None:
        if not dist.is_initialized():
            raise RuntimeError("space_mesh needs an initialized process group")
        space = dist.get_world_size() // data
    return _grid_mesh(("data", "space"), (data, space), device)


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: str = "data"):
    """This rank's contiguous rows of the global batch `x` along `axis`
    (rows [i b, (i + 1) b), b = B / n)."""
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} "
                         f"'{axis}' ranks")
    b = x.shape[0] // n
    i = mesh.axis_index(axis)
    return x[i * b:(i + 1) * b]


def tensor_leaves(tree):
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensor_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def replicate(mesh: Mesh, tree):
    """Broadcast every tensor leaf of `tree` (dicts and lists of tensors,
    on the mesh's device) in place from rank 0, the mesh's first; returns
    the tree."""
    _require_world(mesh.size)
    for t in tensor_leaves(tree):
        dist.broadcast(t, 0)
    return tree


# -----------------------------------------------------------------------------
# collectives

class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradient over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, a new tensor; under
    autograd its gradient is the sum of the ranks' gradients."""
    return _AllReduceSum.apply(x, group)


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over `group` of each rank's `x`, for statistics of shards
    of equal size: sum(x / n). In a group of one it is `x * 1.0`, the same
    bits as `x`."""
    return all_reduce_sum(x * (1.0 / group_size(group)), group)

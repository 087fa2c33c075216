"""The rank mesh and the collectives of the multi-process paths (port of
geomconsistentfr_tpu/parallel/mesh.py).

JAX lays its devices out as a `Mesh` and reduces over named axes inside
`shard_map`; here every rank is a process of torch.distributed, and each
axis of the mesh is a process group:
  * `make_mesh()`: a 1-D mesh over the world (axis 'data'). Data
    parallelism shards the batch over it; `Relighter(parallel='samples')`
    shards the march's t grid over it instead.
  * `make_mesh_grid(n_data, n_samples)`: a 2-D ('data', 'samples') mesh,
    rank = data_index * n_samples + sample_index, as JAX reshapes its device
    list. The first axis shards the batch, the second the t grid.
Every rank must build the same meshes in the same order: each builds the
process groups of every row and column (torch.distributed.new_group is a
collective over the world).

An axis of size 1 has no group (None): a reduction over it is the value
itself. The collectives below take such a group and do nothing with it.

The collectives:
  * `all_min`: the elementwise MIN over a group (not differentiable; the
    march combines with it inside its own autograd Function). The
    sample-sharded march reduces its int64 (distance, t) keys with it, one
    collective a march (ops/shadows_cuda: gloo and NCCL both take int64 MIN);
  * `all_sum`, `all_mean`: differentiable; their backward sums the
    cotangent over the group, as JAX's psum transposes. A loss built from
    them is the same value on every rank, and the gradient of the global
    batch is the rank's gradient averaged over the ranks
    (`average_gradients`), exactly as `pmean` of the gradients in the JAX
    step gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SAMPLES_AXIS = "samples"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D or 2-D mesh of ranks, and its groups.

    `shape` and `axis_names` are JAX's (`mesh.shape[name]` there is
    `axis_size(name)` here); `coords` is this rank's index along each axis and
    `groups` its process group along each axis (None where the axis has
    size 1). `world_group` spans every rank of the mesh (None for one rank).
    """

    axis_names: tuple
    shape: tuple
    rank: int
    coords: tuple
    groups: tuple
    world_group: Optional[object]
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def _axis(self, name: str) -> int:
        try:
            return self.axis_names.index(name)
        except ValueError:
            raise ValueError(f"the mesh has axes {self.axis_names}, not {name!r}") from None

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self._axis(name)]

    def group(self, name: str):
        return self.groups[self._axis(name)]

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's contiguous slice of a batch sharded over the first (data) axis."""
        n, i = self.shape[0], self.coords[0]
        per = global_batch // n
        if per * n != global_batch:
            raise ValueError(f"batch {global_batch} does not split evenly over the {n} ranks of the data axis")
        return slice(i * per, (i + 1) * per)


def _world() -> tuple:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_device(device) -> torch.device:
    """`device`, or this rank's current CUDA device; raises when CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _new_group(ranks: Sequence[int]):
    return dist.new_group(list(ranks)) if len(ranks) > 1 else None


def make_mesh(device=None) -> Mesh:
    """A 1-D mesh over every rank of the world (one rank without torch.distributed)."""
    rank, world = _world()
    group = dist.group.WORLD if world > 1 else None
    return Mesh((DATA_AXIS,), (world,), rank, (rank,), (group,), group, _rank_device(device))


def make_mesh_grid(n_data: int, n_samples: int, device=None) -> Mesh:
    """A 2-D (data x samples) mesh over the world, which must hold n_data * n_samples ranks.

    The data axis shards batches; the samples axis shards the march's t
    grid, and the per-pixel MIN over it is its only traffic in serving.
    """
    rank, world = _world()
    if world != n_data * n_samples:
        raise ValueError(f"a {n_data}x{n_samples} grid needs {n_data * n_samples} ranks, the world has {world}")
    i, j = divmod(rank, n_samples)
    # Every rank creates every group, in one order.
    columns = [_new_group([a * n_samples + b for a in range(n_data)]) if n_data > 1 else None
               for b in range(n_samples)]
    rows = [_new_group([a * n_samples + b for b in range(n_samples)]) if n_samples > 1 else None
            for a in range(n_data)]
    world_group = dist.group.WORLD if world > 1 else None
    return Mesh((DATA_AXIS, SAMPLES_AXIS), (n_data, n_samples), rank, (i, j), (columns[j], rows[i]), world_group,
                _rank_device(device))


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_min(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise MIN of x (float or integer) over the group (a new tensor; no gradient)."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order (no gradient)."""
    if group is None:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group; differentiable, its backward sums over the group too."""
    if group is None:
        return x
    return _AllSum.apply(x.contiguous(), group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """all_sum(x) / the group's size (JAX's pmean)."""
    if group is None:
        return x
    return all_sum(x, group) / group_size(group)


@torch.no_grad()
def average_gradients(params, group) -> None:
    """Replace each .grad by its mean over the group, in one flat all-reduce.

    The result is the same bits on every rank, so replicas that step the
    same optimizer from the same state stay bit-identical.
    """
    if group is None:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= group_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n

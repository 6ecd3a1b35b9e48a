"""Tensor parallelism for the model code: a rank's shard of a logical axis,
and the collectives that put the shards back together.

The reference lowers its ``with_logical_constraint`` sites into collectives
through GSPMD.  The port runs the model on plain local tensors (the CUDA
kernels take plain tensors) and names the collectives itself, at those
sites:

* :func:`shard_of` — the ``(offset, size)`` of this rank's slice of a
  dimension of ``total`` elements on logical axis ``logical``, under the
  active mesh and rules (``sharding.use_mesh``): the slice that
  ``logical_pspec`` / ``shard_slices`` give its parameters.
* :func:`all_reduce_sum`, :func:`all_reduce_max`, :func:`all_gather` over
  the mesh axis that a :class:`Shard` is split on.

Where no ``DeviceMesh`` is active, or the axis is not split (a rule that
maps it to nothing, or a size its mesh axes do not divide), the shard is the
whole dimension and every collective returns its input: the single-device
paths run exactly the code they ran before.  The calls are the plain
``torch.distributed`` ones (no autograd: the cells that use them are
inference only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .sharding import active_mesh, entry_axes, is_device_mesh, logical_pspec


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's ``[offset, offset + size)`` of a dimension of ``total``,
    split over ``parts`` ranks of mesh axis ``axis`` (None: not split)."""

    offset: int
    size: int
    total: int
    axis: Optional[str] = None
    parts: int = 1

    @property
    def split(self) -> bool:
        return self.parts > 1

    @property
    def slice(self) -> slice:
        return slice(self.offset, self.offset + self.size)


def shard_of(logical: str, total: int) -> Shard:
    """This rank's shard of a ``total``-long dimension on ``logical``."""
    mesh = active_mesh()
    whole = Shard(0, total, total)
    if not is_device_mesh(mesh):
        return whole
    axes = entry_axes(logical_pspec((logical,), (total,), mesh)[0])
    if not axes:
        return whole
    if len(axes) > 1:
        raise NotImplementedError(f"tensor-parallel {logical!r} over several mesh axes {axes}")
    axis = axes[0]
    parts = mesh.size(mesh.mesh_dim_names.index(axis))
    if parts == 1:
        return whole
    size = total // parts
    return Shard(mesh.get_local_rank(axis) * size, size, total, axis, parts)


def _group(shard: Shard):
    return active_mesh().get_group(shard.axis)


def all_reduce_sum(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum over the ranks of ``shard``'s axis, in fp32 at least: bf16 /
    fp16 partial products are widened, summed and rounded once (in place
    on ``t`` where it is fp32)."""
    if not shard.split:
        return t
    wide = t.float()
    dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=_group(shard))
    return wide.to(t.dtype)


def all_reduce_max(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The elementwise max over the ranks of ``shard``'s axis (in place)."""
    if shard.split:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_group(shard))
    return t


def all_gather(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order: the
    whole dimension from its shards."""
    if not shard.split:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.parts)]
    dist.all_gather(parts, t, group=_group(shard))
    return torch.cat(parts, dim=dim)

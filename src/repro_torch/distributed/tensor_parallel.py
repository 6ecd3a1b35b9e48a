"""Tensor parallelism for the model code: a rank's shard of a logical axis,
and the collectives that put the shards back together, forward and
backward.

The reference lowers its ``with_logical_constraint`` sites into collectives
through GSPMD, which also partitions their backward.  The port runs the
model on plain local tensors (the CUDA kernels take plain tensors) and
names the collectives itself, at those sites:

* :func:`shard_of` — the ``(offset, size)`` of this rank's slice of a
  dimension of ``total`` elements on logical axis ``logical``, under the
  active mesh and rules (``sharding.use_mesh``): the slice that
  ``logical_pspec`` / ``shard_slices`` give its parameters.
* :func:`all_reduce_sum`, :func:`all_reduce_max`, :func:`all_gather` over
  the mesh axis that a :class:`Shard` is split on, and
  :func:`to_local_region`, which moves nothing forward.

The gradients follow one rule.  A tensor is *replicated* over the axis (the
same value on every rank, and its gradient the same whole gradient on
every rank) or *sharded / partial* (each rank holds a slice, or a summand
of the value).  So:

* ``all_reduce_sum`` (partial -> replicated): backward is the identity;
* ``all_gather`` (sharded -> replicated): backward takes this rank's slice;
* ``take_shard`` (replicated -> sharded, the reverse): forward takes this
  rank's slice, backward gathers the ranks' slices of the gradient into the
  whole gradient (a replicated weight that a rank uses only a shard of: the
  experts under ``parallelism="dp"``);
* ``to_local_region`` (replicated -> rank-local work): identity forward,
  backward the sum of the ranks' partial gradients.  It goes wherever a
  replicated tensor enters work that each rank does on its own shard: the
  input of a column-split weight, KV gathered for a rank's own heads.
* ``from_copies`` (rank-local work whose result every rank computed whole
  -> replicated): identity forward, backward ``1/n`` of the gradient, so
  the ``n`` copies pass the whole gradient into the rank-local work once
  between them (expert-parallel MoE on tokens it cannot split).

Where no ``DeviceMesh`` is active, or the axis is not split (a rule that maps it to
nothing, or a size its mesh axes do not divide), the shard is the whole
dimension and every op returns its input itself, forward and backward: the
single-device paths run exactly the code they ran before.  The group of a
collective is taken when its forward runs, so a backward may run on another
thread (autograd's device thread) than the mesh was activated on.
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
    return entry_shard(logical_pspec((logical,), (total,), mesh)[0], total)


def entry_shard(entry, total: int) -> Shard:
    """This rank's shard of a ``total``-long dimension that a spec entry
    (``None``, a mesh axis, or a tuple of them) puts on the active mesh."""
    axes = entry_axes(entry)
    if not axes:
        return Shard(0, total, total)
    if len(axes) > 1:
        raise NotImplementedError(f"a tensor-parallel dimension over several mesh axes {axes}")
    return axis_shard(axes[0], total)


def axis_shard(axis: str, total: Optional[int] = None) -> Shard:
    """This rank's shard of a ``total``-long dimension split evenly over
    mesh axis ``axis`` of the active mesh (``total`` defaults to the axis's
    size: one element a rank)."""
    mesh = active_mesh()
    parts = mesh.size(mesh.mesh_dim_names.index(axis))
    total = parts if total is None else total
    if parts == 1:
        return Shard(0, total, total)
    size = total // parts
    return Shard(mesh.get_local_rank(axis) * size, size, total, axis, parts)


def _group(shard: Shard):
    return active_mesh().get_group(shard.axis)


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` in fp32 at least (bf16 / fp16 partials are
    widened, summed and rounded once), into a new tensor: the input may be
    saved for a backward."""
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=group)
    return wide.to(t.dtype)


class _AllReduceSum(torch.autograd.Function):
    """Partial -> replicated: the sum forward, the identity backward."""

    @staticmethod
    def forward(ctx, t, group):
        return _sum_over(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGather(torch.autograd.Function):
    """Sharded -> replicated: the ranks' tensors concatenated along ``dim``
    forward, this rank's slice of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, t, dim, shard, group):
        ctx.dim, ctx.index, ctx.size = dim, shard.offset // shard.size, t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(shard.parts)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


class _TakeShard(torch.autograd.Function):
    """Replicated -> sharded: this rank's slice along ``dim`` forward, the
    ranks' gradient slices concatenated along ``dim`` backward."""

    @staticmethod
    def forward(ctx, t, dim, shard, group):
        ctx.dim, ctx.parts, ctx.group = dim, shard.parts, group
        return t.narrow(dim, shard.offset, shard.size)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        parts = [torch.empty_like(grad) for _ in range(ctx.parts)]
        dist.all_gather(parts, grad, group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None, None


class _ToLocalRegion(torch.autograd.Function):
    """Replicated -> rank-local work: the identity forward, the sum of the
    ranks' partial gradients backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group), None


class _FromCopies(torch.autograd.Function):
    """Copies -> replicated: the identity forward, ``1/n`` of the gradient
    backward."""

    @staticmethod
    def forward(ctx, t, parts):
        ctx.parts = parts
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.parts, None


def all_reduce_sum(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum over the ranks of ``shard``'s axis, in fp32 at least: bf16 /
    fp16 partial products are widened, summed and rounded once.  Backward:
    the identity."""
    if not shard.split:
        return t
    return _AllReduceSum.apply(t, _group(shard))


def all_reduce_max(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The elementwise max over the ranks of ``shard``'s axis (in place; no
    gradient)."""
    if shard.split:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_group(shard))
    return t


def all_gather(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order: the
    whole dimension from its shards.  Backward: this rank's slice."""
    if not shard.split:
        return t
    return _AllGather.apply(t, dim, shard, _group(shard))


def take_shard(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``t``, which is whole and
    replicated over ``shard``'s axis.  Backward: the ranks' gradient slices
    gathered, so every rank holds the whole gradient."""
    if not shard.split:
        return t
    if t.shape[dim] != shard.total:
        raise ValueError(f"take_shard: dimension {dim} of {tuple(t.shape)} is not the "
                         f"{shard.total} that the shard splits")
    return _TakeShard.apply(t, dim, shard, _group(shard))


def to_local_region(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``t``, replicated over ``shard``'s axis, entering work each rank does
    on its own shard: the identity forward; backward, the ranks' partial
    gradients summed."""
    if not shard.split:
        return t
    return _ToLocalRegion.apply(t, _group(shard))


def from_copies(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``t``, the same value computed whole on every rank of ``shard``'s
    axis by work that reads rank-local shards, as a replicated tensor: the
    identity forward; backward, ``1/n`` of its (whole) gradient on each
    rank, so the ``n`` copies pass the whole gradient into that work once
    between them."""
    if not shard.split:
        return t
    return _FromCopies.apply(t, shard.parts)

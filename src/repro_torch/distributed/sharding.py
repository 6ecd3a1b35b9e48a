"""Logical-axis sharding rules as DTensor placements (port of
``repro/distributed/sharding.py``).

Model code names *logical* axes; a rules table maps each to mesh axes.  The
rules, ``_resolve_axis`` and ``logical_pspec`` are the reference's: a
mapping that does not divide the dimension is dropped (replicated), and a
mesh axis is used at most once per tensor.  A spec is a tuple with one entry
per tensor dimension, ``None`` | axis | tuple of axes, equal to the
reference's ``PartitionSpec`` entries.

Decisions (DESIGN.md §7):

  batch        -> ("pod", "data")  batch data-parallel across pods
  heads        -> "model"          Q heads tensor-parallel
  kv_heads     -> "model" only when num_kv_heads % model_size == 0, else
                  replicated (GQA KV-dup strategy)
  ffn / vocab  -> "model"
  expert       -> "model"          EP when E % model_size == 0 (else TP-MoE)
  kv_seq       -> "model"          sequence-sharded decode KV (flash-decoding)
  embed/d_model, ssm state, conv   replicated

A mesh is a :class:`MeshSpec` (names and sizes, no devices: the production
meshes of the dry run) or a ``DeviceMesh`` with ``mesh_dim_names`` (ranks
of an initialised process group).  :func:`placements` turns a spec into one
DTensor placement per mesh dimension.  A dimension split over several mesh
axes nests them major-first, as JAX's tuple does; DTensor nests ``Shard(d)``
on several mesh dimensions in mesh-dimension order, so such a tuple must be
in mesh order, and :func:`placements` refuses one that is not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from ..interop import tree_map

LogicalAxis = Optional[str]
SpecEntry = Union[None, str, Tuple[str, ...]]

DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,           # overridden to "model" for seq-sharded decode
    "embed": None,
    "heads": "model",
    "kv_heads": "model",      # applied only if divisible; see below
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ffn": "model",    # TP-MoE: shard the expert FFN dim instead
    "moe_cap": ("pod", "data"),   # MoE dispatch capacity dim
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "heads_qk": None,         # mLSTM q/k width (replicated; H=4 < model axis)
    "heads_v": None,
    "pages": "model",         # paged-KV page pool sharded over model axis
    "stage": None,
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, without devices."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def mesh_spec(mesh) -> MeshSpec:
    """``mesh`` (a MeshSpec or a named DeviceMesh) as a MeshSpec."""
    if isinstance(mesh, MeshSpec):
        return mesh
    if not mesh.mesh_dim_names:
        raise ValueError("a DeviceMesh needs mesh_dim_names to take logical rules")
    return MeshSpec(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, MeshSpec)


class _ShardingCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = dict(DEFAULT_RULES)


_CTX = _ShardingCtx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh (MeshSpec or DeviceMesh) + logical rules for this
    thread."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def active_mesh():
    return _CTX.mesh


def active_rules() -> dict:
    """A copy of this thread's rules (``use_mesh``'s, else the defaults)."""
    return dict(_CTX.rules)


def _resolve_axis(logical: LogicalAxis, mesh: MeshSpec, dim_size: int) -> SpecEntry:
    """Map one logical axis to mesh axes, dropping non-divisible mappings."""
    if logical is None:
        return None
    mapping = _CTX.rules.get(logical)
    if mapping is None:
        return None
    axes = (mapping,) if isinstance(mapping, str) else tuple(mapping)
    # keep only axes present in this mesh
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    total = math.prod(mesh.sizes[a] for a in axes)
    if dim_size % total != 0:
        return None  # non-divisible -> replicate (e.g. kv_heads=8 on model=16)
    return axes if len(axes) > 1 else axes[0]


def entry_axes(entry: SpecEntry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_pspec(logical_axes: Sequence[LogicalAxis], shape: Sequence[int],
                  mesh=None) -> tuple:
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return (None,) * len(logical_axes)
    mesh = mesh_spec(mesh)
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    used: set = set()
    out = []
    for ax, n in zip(logical_axes, shape):
        r = _resolve_axis(ax, mesh, n)
        # one mesh axis may appear at most once in a spec
        flat = entry_axes(r)
        if r is None or any(a in used for a in flat):
            out.append(None)
        else:
            used.update(flat)
            out.append(r)
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """One DTensor placement per mesh dimension: ``Shard(d)`` where the
    spec puts tensor dim ``d`` on that mesh axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    ms = mesh_spec(mesh)
    out = [Replicate() for _ in ms.axis_names]
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [ms.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {ms.axis_names}: "
                             "DTensor nests shards in mesh-dimension order")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard_slices(spec: tuple, shape: Sequence[int], mesh, coord=None) -> tuple:
    """The slice of a tensor of ``shape`` that the rank at mesh coordinate
    ``coord`` (this rank's, by default) holds under ``spec``."""
    ms = mesh_spec(mesh)
    if coord is None:
        coord = mesh.get_coordinate()
    at = dict(zip(ms.axis_names, coord))
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        idx, parts = 0, 1
        for a in entry_axes(entry):       # major first
            idx = idx * ms.sizes[a] + at[a]
            parts *= ms.sizes[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def gather_shard(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``local`` shard under ``spec``:
    ``DTensor.redistribute`` to ``Replicate()`` on every mesh dimension.
    Shards are even (a spec splits only dimensions its axes divide)."""
    from torch.distributed.tensor import DTensor, Replicate

    dt = DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False)
    return dt.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh, the counterpart of JAX's
    ``NamedSharding``."""

    mesh: object
    spec: tuple
    placements: list


def logical_sharding(logical_axes: Sequence[LogicalAxis], shape: Sequence[int],
                     mesh=None) -> Optional[Sharding]:
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return None
    spec = logical_pspec(logical_axes, shape, mesh)
    return Sharding(mesh, spec, placements(spec, mesh))


def with_logical_constraint(x, *logical_axes: LogicalAxis):
    """Re-place a DTensor activation by the logical rules; a no-op on a
    plain tensor or outside a mesh (one device: tests, smoke runs)."""
    from torch.distributed.tensor import DTensor

    mesh = _CTX.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_pspec(logical_axes, x.shape, mesh)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def param_sharding_tree(logical_tree, shape_tree, mesh=None):
    """Map a tree of logical-axis tuples + shapes to :class:`Sharding`."""
    # imported here: the models import this package's tensor_parallel
    from ..models.common import is_tuple

    mesh = mesh if mesh is not None else _CTX.mesh
    return tree_map(lambda ax, shp: logical_sharding(ax, shp, mesh),
                    logical_tree, shape_tree, is_leaf=is_tuple)

"""Elastic scaling: restore a checkpoint onto a *different* mesh (port of
``repro/distributed/elastic.py``).

Checkpoints store full logical arrays (``ckpt/checkpoint.py``), so resuming
on a grown or shrunk cluster is a placement problem, not a data problem:
rebuild each leaf's placements on the new mesh from the same logical-axis
rules and ``distribute_tensor`` it.  ``plan_remesh`` validates
divisibility up front and reports which leaves the rules leave replicated
— the operator's answer to "can I run this on N devices?" (DESIGN.md §4).
It takes a :class:`~.sharding.MeshSpec` or a ``DeviceMesh``; placing needs
a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..interop import from_numpy, tree_flatten, tree_unflatten
from ..models.common import is_tuple, logical_axes_tree
from ..models.transformer import param_specs
from .sharding import logical_pspec, mesh_spec, placements

PyTree = Any


@dataclasses.dataclass
class RemeshReport:
    ok: bool
    devices: int
    replicated_leaves: int
    sharded_leaves: int
    notes: list


def plan_remesh(cfg: ModelConfig, mesh) -> RemeshReport:
    ms = mesh_spec(mesh)
    specs = tree_flatten(param_specs(cfg))[0]
    nsh = sum(any(e is not None for e in logical_pspec(s.logical_axes, s.shape, ms))
              for s in specs)
    notes = []
    if "model" in ms.axis_names and cfg.d_ff and cfg.d_ff % ms.sizes["model"] != 0:
        notes.append(f"d_ff {cfg.d_ff} not divisible by model axis "
                     f"{ms.sizes['model']} -> FFN replicated")
    return RemeshReport(ok=True, devices=ms.size, replicated_leaves=len(specs) - nsh,
                        sharded_leaves=nsh, notes=notes)


def reshard_tree(cfg: ModelConfig, mesh, host_tree: PyTree) -> PyTree:
    """Place host params (numpy arrays or tensors, the parameter tree) onto
    ``mesh`` (a ``DeviceMesh``) as DTensors, per the logical rules."""
    from torch.distributed.tensor import distribute_tensor

    axes = tree_flatten(logical_axes_tree(param_specs(cfg)), is_tuple)[0]
    leaves, treedef = tree_flatten(host_tree)
    assert len(axes) == len(leaves), "tree does not match the config's parameters"
    out = []
    for ax, leaf in zip(axes, leaves):
        t = leaf if isinstance(leaf, torch.Tensor) else from_numpy(np.asarray(leaf))
        spec = logical_pspec(ax, t.shape, mesh)
        out.append(distribute_tensor(t, mesh, placements(spec, mesh)))
    return tree_unflatten(treedef, out)


def restore_train_state_elastic(cfg: ModelConfig, mesh, store, manifest: dict,
                                like_state: PyTree) -> tuple:
    """Restore a store-mode training checkpoint onto a DIFFERENT mesh.

    The image is a ``{"params", "opt": {"m", "v"}, "step"}`` tree written
    by ``ckpt.save_tree_to_store`` (one batched read restores it); params
    and both AdamW moment trees — structurally identical to params — are
    re-placed with the parameters' own logical-axis rules.  Returns
    ``(state, RemeshReport)`` (DESIGN.md §18.5).
    """
    from ..ckpt.checkpoint import restore_tree_from_store

    report = plan_remesh(cfg, mesh)
    host = restore_tree_from_store(store, manifest, like_state)
    out = dict(host)
    out["params"] = reshard_tree(cfg, mesh, host["params"])
    if isinstance(host.get("opt"), dict):
        out["opt"] = {k: (reshard_tree(cfg, mesh, t) if k in ("m", "v") else t)
                      for k, t in host["opt"].items()}
    return out, report

"""One training step: loss -> grads -> AdamW (port of ``repro/train/train_step.py``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
which are detached first, so no graph reaches back into the caller's
tensors and none outlives the step.  The data-parallel step with ZeRO-1
moments over a ``DeviceMesh`` (``launch/specs.build_cell``) takes its local
gradients from :func:`step_grads` and reduces them itself; the int8
compressed reduction is ``distributed/collectives.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..configs.base import ModelConfig
from ..interop import tree_flatten, tree_map, tree_unflatten
from ..models.transformer import forward_train
from .loss import chunked_cross_entropy
from .optimizer import AdamWConfig, AdamWState, apply_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    moe_lb_coeff: float = 0.01
    moe_z_coeff: float = 0.001
    z_loss_coeff: float = 1e-4
    loss_chunk: int = 1024
    microbatches: int = 1        # sequential microbatching (grad accumulation)


def loss_fn(cfg: ModelConfig, tcfg: TrainConfig, params: dict, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    hidden, aux = forward_train(cfg, params, batch)
    loss, metrics = chunked_cross_entropy(
        cfg, params, hidden, batch["labels"], batch.get("loss_mask"),
        chunk=tcfg.loss_chunk, z_loss_coeff=tcfg.z_loss_coeff)
    if aux:
        loss = (loss
                + tcfg.moe_lb_coeff * aux["moe_lb_loss"]
                + tcfg.moe_z_coeff * aux["moe_z_loss"])
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def value_and_grad(cfg: ModelConfig, tcfg: TrainConfig, params: dict, batch: dict
                   ) -> Tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of :func:`loss_fn`; everything returned is
    detached, and ``grads`` has the tree of ``params``."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tcfg, tree_unflatten(treedef, leaves), batch)
        # a leaf the loss does not read (an embeddings model's token
        # table) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(treedef, list(grads))


def step_grads(cfg: ModelConfig, tcfg: TrainConfig, params: dict, batch: dict
               ) -> Tuple[dict, dict]:
    """(metrics, grads) of one step's batch, over sequential microbatches
    when ``tcfg.microbatches`` > 1 (their mean loss and gradient)."""
    if tcfg.microbatches <= 1:
        _, metrics, grads = value_and_grad(cfg, tcfg, params, batch)
    else:
        mb = tcfg.microbatches
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss = 0.0
        for i in range(mb):
            mbatch = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
            l, metrics, g = value_and_grad(cfg, tcfg, params, mbatch)
            grads = tree_map(lambda a, b: a + b.float() / mb, grads, g)
            loss = loss + l / mb
        metrics["loss"] = loss
    return metrics, grads


def train_step(cfg: ModelConfig, tcfg: TrainConfig, params: dict,
               opt_state: AdamWState, batch: dict
               ) -> Tuple[dict, AdamWState, dict]:
    """One optimizer step (optionally over sequential microbatches)."""
    metrics, grads = step_grads(cfg, tcfg, params, batch)
    params, opt_state, opt_metrics = apply_update(tcfg.optimizer, params, grads, opt_state)
    metrics.update(opt_metrics)
    return params, opt_state, metrics

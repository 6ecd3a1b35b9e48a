"""Loss: sequence-chunked softmax cross-entropy (port of ``repro/train/loss.py``).

The JAX package scans over sequence chunks so that the live logits tensor
is ``[B, chunk, V]``; here the scan is a Python loop over the same chunks,
with the same fp32 logits, ``logsumexp``, gold logit, z-loss and mask
padding.  Autograd keeps each chunk's fp32 logits for the backward, as the
reference's scan does (no per-chunk checkpoint).

With the vocabulary split over the mesh (the tensor-parallel train cell)
each rank keeps only its columns of a chunk's logits, ``[B, chunk, V /
model]``, and the softmax's pieces cross the ranks instead: the row max
(detached: the log-sum-exp does not depend on it), then one sum of each
row's ``sum exp(logits - max)`` and gold logit (the rank owning the label's
column gives it, the others zero).  Without a split the loss is the code
above, op for op.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.tensor_parallel import Shard, all_reduce_max, all_reduce_sum, shard_of
from ..models.transformer import lm_logits


def _split_lse_gold(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                    labels: torch.Tensor, vs: Shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, gold logit) [B, chunk] of a chunk whose vocabulary is
    split over ``vs``'s axis: this rank's fp32 columns (padded ones masked
    by their global index), the row max over the ranks, then one sum of
    ``sum exp(logits - max)`` and the owned gold logit."""
    logits = lm_logits(cfg, params, hidden, gather=False).float()
    m = all_reduce_max(logits.detach().amax(dim=-1), vs)
    ids = labels.long() - vs.offset
    own = (ids >= 0) & (ids < vs.size)
    gold = torch.gather(logits, -1, ids.clamp(0, vs.size - 1)[..., None])[..., 0]
    parts = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                         torch.where(own, gold, torch.zeros_like(gold))])
    sum_exp, gold = all_reduce_sum(parts, vs).unbind(0)
    return m + torch.log(sum_exp), gold


def chunked_cross_entropy(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = 1024,
                          z_loss_coeff: float = 0.0,
                          ) -> Tuple[torch.Tensor, dict]:
    """hidden [B,S,d], labels [B,S] -> (mean NLL over mask, metrics)."""
    b, s, _ = hidden.shape
    cs = min(chunk, s)
    vs = shard_of("vocab", cfg.padded_vocab)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=hidden.device)
    if s % cs:
        pad = cs - s % cs
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    mask = mask.float()
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll_sum, z_sum, cnt = zero, zero, zero
    for c in range(hidden.shape[1] // cs):
        sl = slice(c * cs, (c + 1) * cs)
        m_c = mask[:, sl]
        if vs.split:
            lse, gold = _split_lse_gold(cfg, params, hidden[:, sl], labels[:, sl], vs)
        else:
            logits = lm_logits(cfg, params, hidden[:, sl]).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        nll = (lse - gold) * m_c
        zl = torch.square(lse) * m_c
        nll_sum, z_sum, cnt = nll_sum + nll.sum(), z_sum + zl.sum(), cnt + m_c.sum()
    cnt = torch.maximum(cnt, torch.ones_like(cnt))
    loss = nll_sum / cnt
    if z_loss_coeff:
        loss = loss + z_loss_coeff * z_sum / cnt
    return loss, {"nll": nll_sum / cnt, "tokens": cnt}

"""Loss: sequence-chunked softmax cross-entropy (port of ``repro/train/loss.py``).

The JAX package scans over sequence chunks so that the live logits tensor
is ``[B, chunk, V]``; here the scan is a Python loop over the same chunks,
with the same fp32 logits, ``logsumexp``, gold logit, z-loss and mask
padding.  Autograd keeps each chunk's fp32 logits for the backward, as the
reference's scan does (no per-chunk checkpoint).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..models.transformer import lm_logits


def chunked_cross_entropy(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = 1024,
                          z_loss_coeff: float = 0.0,
                          ) -> Tuple[torch.Tensor, dict]:
    """hidden [B,S,d], labels [B,S] -> (mean NLL over mask, metrics)."""
    b, s, _ = hidden.shape
    cs = min(chunk, s)
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

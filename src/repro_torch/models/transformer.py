"""Model assembly for the decoder-only, token-input LM (port of
``repro/models/transformer.py``).

Entry points (functions of (cfg, params, ...), as in the JAX package):

  param_specs / init_params       parameter tree (segments stacked [count, ...])
  embed_tokens / lm_logits        token embedding and tied/untied LM head
  init_cache                      contiguous cache for (batch, seq_len)
  forward_train                   full-sequence forward for the loss; with
                                  ``remat="full"`` each layer is recomputed
                                  in the backward (``torch.utils.checkpoint``)
  prefill                         writes the cache, returns last-position hidden;
                                  without explicit ``positions`` its attention
                                  runs the flash_attention kernel
  decode_step                     one token per sequence through the cache

Each homogeneous segment runs as a Python loop over its stacked layers
(the JAX package scanned them with ``jax.lax.scan``); sharding constraints
are dropped (one device).  Caches are updated in place; a function that
takes a cache returns it (with any new entries, such as the paged ``len``).
Encoder-decoder, embedding inputs, M-RoPE and meta tokens are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device, torch_dtype
from ..configs.base import ModelConfig, Segment
from ..interop import tree_map
from .blocks import BlockCtx, block_apply, block_cache_init, block_param_specs
from .common import ParamSpec, init_param_tree, normal_init, ones_init, stack_specs
from .layers import rms_norm

NEG_INF = -1.0e9


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.is_encdec or cfg.input_mode != "tokens" or cfg.num_meta_tokens
            or cfg.mrope_sections is not None):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs decoder-only token models without "
            f"meta tokens or M-RoPE so far (ROADMAP.md, Queue 1)")


def cast_params(cfg: ModelConfig, params: dict) -> dict:
    """Cast float params to the compute dtype (mixed-precision forward).
    Tensors already in the compute dtype are returned as they are, so a
    caller that casts once (the serving engine) pays nothing per step."""
    compute = torch_dtype(cfg.compute_dtype)

    def cast(a):
        if a.is_floating_point() and a.dtype != compute:
            return a.to(compute)
        return a

    return tree_map(cast, params)


# ------------------------------------------------------------------- params


def param_specs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                           lambda g, s, d: normal_init(g, s, d, 0.02)),
        "segments": [stack_specs(block_param_specs(cfg, seg), seg.count)
                     for seg in cfg.decoder_plan()],
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), ones_init),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"),
                                     lambda g, s, d: normal_init(g, s, d, 0.02))
    return specs


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device="cuda") -> dict:
    """Random weights from ``seed`` (a CPU ``torch.Generator``, so the same
    seed gives the same weights on any device), in ``param_dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_param_tree(param_specs(cfg), gen,
                           torch_dtype(dtype or cfg.param_dtype), dev)


# -------------------------------------------------------------------- embed


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))


def lm_logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [.., d] -> logits [.., padded_vocab], padded region masked."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ w.to(hidden.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


# ------------------------------------------------------------ layer loops


def _run_segment(cfg: ModelConfig, seg: Segment, seg_params: dict, x,
                 ctx: BlockCtx, cache_seg: Optional[dict]):
    """Run one homogeneous segment layer by layer.  cache_seg holds
    [count, ...] tensors or is None.  Entries a block updated in place come
    back as the segment's own tensors; new per-layer entries are stacked.
    In training with ``cfg.remat == "full"`` each layer runs under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of the
    scan body): only its input is kept, and its forward runs again in the
    backward."""
    old_layers: List[dict] = []
    new_layers: List[dict] = []
    remat = ctx.mode == "train" and cfg.remat == "full"
    for i in range(seg.count):
        layer_p = tree_map(lambda a: a[i], seg_params)
        cache_l = None if cache_seg is None else {k: t[i] for k, t in cache_seg.items()}
        lctx = dataclasses.replace(ctx, cache=cache_l)
        if remat:
            # the layer's own tree and context, bound now: the recompute
            # runs in the backward, after this loop has moved on
            x = checkpoint(lambda x_, p_=layer_p, c_=lctx: block_apply(cfg, seg, p_, x_, c_)[0],
                           x, use_reentrant=False)
            new_cache = None
        else:
            x, new_cache, _ = block_apply(cfg, seg, layer_p, x, lctx)
        old_layers.append(cache_l)
        new_layers.append(new_cache)
    if cache_seg is None or new_layers[0] is None:
        return x, cache_seg
    out = {}
    for key in new_layers[0]:
        if all(new[key] is old.get(key) for new, old in zip(new_layers, old_layers)):
            out[key] = cache_seg[key]              # written in place
        else:
            out[key] = torch.stack([new[key] for new in new_layers])
    return x, out


# ------------------------------------------------------------------ forward


def forward_train(cfg: ModelConfig, params: dict, batch: dict
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward -> (hidden [B,S,d] after the final norm, aux).

    ``aux`` holds the MoE losses in the JAX package; the dense decoder has
    none, so it is empty.  Attention takes the plain dense or chunked path
    (``models/layers.py``), whose chunked form has the flash-style
    backward; the ``flash_attention`` kernel has no backward and is not
    used here.
    """
    _check_supported(cfg)
    params = cast_params(cfg, params)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    ctx = BlockCtx(mode="train", positions=positions)
    for i, seg in enumerate(cfg.decoder_plan()):
        x, _ = _run_segment(cfg, seg, params["segments"][i], x, ctx, None)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), {}


# -------------------------------------------------------------------- cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               device="cuda") -> list:
    """Stacked per-segment caches sized for ``seq_len`` total positions."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.compute_dtype)
    caches = []
    for seg in cfg.decoder_plan():
        layer = block_cache_init(cfg, seg, batch, seq_len, dt, dev)
        caches.append({k: t.unsqueeze(0).repeat((seg.count,) + (1,) * t.dim())
                       for k, t in layer.items()})
    return caches


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: list
            ) -> Tuple[torch.Tensor, list]:
    """Run the prompt, writing caches.  Returns (last hidden [B,d], cache)."""
    _check_supported(cfg)
    params = cast_params(cfg, params)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    b, s = tokens.shape
    positions = batch.get("positions")
    default_positions = positions is None
    if default_positions:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    ctx = BlockCtx(mode="prefill", positions=positions,
                   default_positions=default_positions)
    new_caches = []
    for i, seg in enumerate(cfg.decoder_plan()):
        x, nc = _run_segment(cfg, seg, params["segments"][i], x, ctx, cache[i])
        new_caches.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1], new_caches


def decode_step(cfg: ModelConfig, params: dict, cache: list,
                tokens: torch.Tensor, cur_pos: torch.Tensor
                ) -> Tuple[torch.Tensor, list]:
    """One decode step.  tokens: [B] int32; cur_pos: [B] absolute position.

    ``cache`` is contiguous ({k, v, pos}) or paged ({k_pool, v_pool, table,
    len}); paged attention runs the CUDA kernel for CUDA tensors and the
    plain version for CPU tensors.
    Returns (logits [B, padded_vocab], cache).
    """
    _check_supported(cfg)
    params = cast_params(cfg, params)
    x = embed_tokens(cfg, params, tokens[:, None])
    ctx = BlockCtx(mode="decode", positions=cur_pos[:, None], cur_pos=cur_pos)
    new_caches = []
    for i, seg in enumerate(cfg.decoder_plan()):
        x, nc = _run_segment(cfg, seg, params["segments"][i], x, ctx, cache[i])
        new_caches.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x[:, 0]), new_caches

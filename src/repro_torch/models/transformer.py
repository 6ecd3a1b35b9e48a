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
A model with meta tokens (hymba) runs a learned prefix of
``num_meta_tokens`` positions ahead of every prompt; ``forward_train``
strips it from the hidden it returns.  An MoE model's ``forward_train``
returns its aux losses averaged over the layers.  Encoder-decoder,
embedding inputs and M-RoPE are not ported yet.
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
    if cfg.is_encdec or cfg.input_mode != "tokens" or cfg.mrope_sections is not None:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs decoder-only token models without "
            f"M-RoPE so far; encoder-decoder, embedding inputs and M-RoPE come "
            f"in a later slice (ROADMAP.md, Queue 1 item 7)")


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
    if cfg.num_meta_tokens:
        specs["meta_tokens"] = ParamSpec((cfg.num_meta_tokens, cfg.d_model),
                                         (None, "embed"),
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
    """Run one homogeneous segment layer by layer -> (x, cache, aux).

    cache_seg holds [count, ...] tensors or is None.  Entries a block
    updated in place come back as the segment's own tensors; new per-layer
    entries are stacked.  ``aux`` sums each layer's aux losses in fp32
    (empty where the blocks have none).  In training with ``cfg.remat ==
    "full"`` each layer runs under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` of the scan body): only its input is kept,
    and its forward runs again in the backward."""
    old_layers: List[dict] = []
    new_layers: List[dict] = []
    aux_sum: Dict[str, torch.Tensor] = {}
    remat = ctx.mode == "train" and cfg.remat == "full"
    for i in range(seg.count):
        layer_p = tree_map(lambda a: a[i], seg_params)
        cache_l = None if cache_seg is None else {k: t[i] for k, t in cache_seg.items()}
        lctx = dataclasses.replace(ctx, cache=cache_l)
        if remat:
            # the layer's own tree and context, bound now: the recompute
            # runs in the backward, after this loop has moved on
            x, aux = checkpoint(
                lambda x_, p_=layer_p, c_=lctx: block_apply(cfg, seg, p_, x_, c_)[0::2],
                x, use_reentrant=False)
            new_cache = None
        else:
            x, new_cache, aux = block_apply(cfg, seg, layer_p, x, lctx)
        for k, v in aux.items():
            aux_sum[k] = aux_sum[k] + v.float() if k in aux_sum else v.float()
        old_layers.append(cache_l)
        new_layers.append(new_cache)
    if cache_seg is None or new_layers[0] is None:
        return x, cache_seg, aux_sum
    out = {}
    for key in new_layers[0]:
        if all(new[key] is old.get(key) for new, old in zip(new_layers, old_layers)):
            out[key] = cache_seg[key]              # written in place
        else:
            out[key] = torch.stack([new[key] for new in new_layers])
    return x, out, aux_sum


def _input_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor]):
    """(x [B,S',d], positions [B,S'], default) with the meta-token prefix
    ahead of the tokens (S' = num_meta_tokens + S): the prefix takes
    positions 0..m-1 and the tokens' positions move up by m.  ``default``
    says the positions are ``0..S'-1`` in every row (the caller passed
    none), which the flash_attention prefill needs."""
    x = embed_tokens(cfg, params, tokens)
    b, s = tokens.shape
    default = positions is None
    if default:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    m = cfg.num_meta_tokens
    if m:
        meta = params["meta_tokens"].to(x.dtype).expand(b, m, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        mpos = torch.arange(m, dtype=positions.dtype, device=positions.device).expand(b, m)
        positions = torch.cat([mpos, positions + m], dim=1)
    return x, positions, default


# ------------------------------------------------------------------ forward


def forward_train(cfg: ModelConfig, params: dict, batch: dict
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward -> (hidden [B,S,d] after the final norm, aux).

    ``aux`` holds an MoE model's ``moe_lb_loss``, ``moe_z_loss`` and
    ``moe_drop_frac``, each summed over
    the layers and divided by ``num_layers``, as the JAX package does; a
    model without experts returns ``{}``.  The meta-token prefix (hymba)
    is stripped from the hidden, so the loss sees the input's length.
    Attention takes the plain dense or chunked path
    (``models/layers.py``), whose chunked form has the flash-style
    backward; the ``flash_attention`` kernel has no backward and is not
    used here.
    """
    _check_supported(cfg)
    params = cast_params(cfg, params)
    x, positions, _ = _input_hidden(cfg, params, batch["tokens"], batch.get("positions"))
    ctx = BlockCtx(mode="train", positions=positions)
    aux_total: Dict[str, torch.Tensor] = {}
    for i, seg in enumerate(cfg.decoder_plan()):
        x, _, aux = _run_segment(cfg, seg, params["segments"][i], x, ctx, None)
        for k, v in aux.items():
            aux_total[k] = aux_total[k] + v if k in aux_total else v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.num_meta_tokens:
        x = x[:, cfg.num_meta_tokens:]
    if cfg.num_experts <= 0:
        return x, {}
    return x, {k: v / float(cfg.num_layers) for k, v in aux_total.items()}


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
    x, positions, default_positions = _input_hidden(cfg, params, batch["tokens"],
                                                    batch.get("positions"))
    ctx = BlockCtx(mode="prefill", positions=positions,
                   default_positions=default_positions)
    new_caches = []
    for i, seg in enumerate(cfg.decoder_plan()):
        x, nc, _ = _run_segment(cfg, seg, params["segments"][i], x, ctx, cache[i])
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
        x, nc, _ = _run_segment(cfg, seg, params["segments"][i], x, ctx, cache[i])
        new_caches.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x[:, 0]), new_caches

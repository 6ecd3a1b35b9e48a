"""Model assembly: the decoder-only LM over tokens or embeddings, and the
encoder-decoder (port of ``repro/models/transformer.py``).

Entry points (functions of (cfg, params, ...), as in the JAX package):

  param_specs / init_params       parameter tree (segments stacked [count, ...])
  embed_tokens / lm_logits        token embedding and tied/untied LM head
  init_cache                      contiguous cache for (batch, seq_len)
  forward_train                   full-sequence forward for the loss; with
                                  ``remat="full"`` each layer is recomputed
                                  in the backward (``torch.utils.checkpoint``)
  prefill                         writes the cache, returns last-position hidden;
                                  where its mask positions are 0..S-1 its
                                  attention runs the flash_attention kernel
  decode_step                     one token per sequence through the cache

Each homogeneous segment runs as a Python loop over its stacked layers
(the JAX package scanned them with ``jax.lax.scan``).  Under an active
``DeviceMesh`` (the train, prefill and decode cells, ``launch/specs.py``)
the params are each rank's shards and the reference's sharding constraints
become explicit collectives, differentiable (``distributed/
tensor_parallel.py``): the embedding and the LM head split on ``vocab``
(the training loss reads this rank's columns, ``train/loss.py``), attention
on ``heads`` / ``kv_heads`` (and the decode cache on ``kv_seq``, or on
``kv_heads`` where the mesh does not divide its length; the encoder-decoder's
memory KV on ``kv_heads``), the MLP on ``ffn``, the Mamba mixer and the
mLSTM on ``ssm_inner``; a rematerialised layer recomputes under the mesh its
forward ran under.  Without a mesh every collective is the identity.  Caches are
updated in place; a function that takes a cache returns it (with any new
entries, such as the paged ``len``).
A model with meta tokens (hymba) runs a learned prefix of
``num_meta_tokens`` positions ahead of every prompt; ``forward_train``
strips it from the hidden it returns.  An MoE model's ``forward_train``
returns its aux losses averaged over the layers.

A model with ``input_mode == "embeds"`` (qwen2-vl) takes ``batch["embeds"]``
[B, S, d] (the stubbed vision frontend's patch embeddings) and, under
M-RoPE, ``batch["positions"]`` [B, 3, S]; its prefill runs the kernel only
where the temporal row is ``0..S-1`` in every row, the one case where the
kernel's index mask equals the reference's temporal one, and the plain
attention otherwise.  ``prefill_routes`` counts prefills by route.  An
encoder-decoder (seamless) runs its encoder over ``batch["src_embeds"]``
[B, Sm, d] (the stubbed speech frontend's frames); ``prefill`` stores each
decoder layer's memory KV in the cache (``xk`` / ``xv``), which decode reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device, torch_dtype
from ..configs.base import ModelConfig, Segment
from ..distributed.sharding import active_mesh, active_rules, is_device_mesh, use_mesh
from ..distributed.tensor_parallel import all_gather, all_reduce_sum, shard_of, to_local_region
from ..interop import tree_map
from .blocks import BlockCtx, block_apply, block_cache_init, block_param_specs, first_free_slot
from .common import (ParamSpec, init_param_tree, logical_axes_tree, normal_init, ones_init,
                     stack_specs)
from .layers import rms_norm

NEG_INF = -1.0e9

# prefills of a model with attention, by the route of their decoder
# self-attention: "kernel" (flash_attention) or "plain"
prefill_routes: Dict[str, int] = {"kernel": 0, "plain": 0}


def reset_prefill_routes() -> None:
    for k in prefill_routes:
        prefill_routes[k] = 0


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
    # the token embedding also serves an embeddings model's text decode
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                           lambda g, s, d: normal_init(g, s, d, 0.02)),
    }
    if cfg.is_encdec:
        # the encoder consumes the stub frame embeddings directly
        specs["encoder"] = [stack_specs(block_param_specs(cfg, seg), seg.count)
                            for seg in cfg.encoder_plan()]
        specs["enc_norm"] = ParamSpec((cfg.d_model,), ("embed",), ones_init)
    specs["segments"] = [stack_specs(block_param_specs(cfg, seg), seg.count)
                         for seg in cfg.decoder_plan()]
    specs["final_norm"] = ParamSpec((cfg.d_model,), ("embed",), ones_init)
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


def param_logical_axes(cfg: ModelConfig) -> dict:
    return logical_axes_tree(param_specs(cfg))


# -------------------------------------------------------------------- embed


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``embed``.  Split on vocab, each rank looks up the ids in its
    range, writes zeros for the others, and the ranks' rows are summed: one
    rank contributes each row, so the sum is the lookup's bits.  Backward,
    the sum is the identity and the zeros stop the gradient, so each rank's
    rows get the gradient of the positions that read them."""
    vs = shard_of("vocab", cfg.padded_vocab)
    ids = tokens.long()
    if not vs.split:
        return params["embed"][ids].to(torch_dtype(cfg.compute_dtype))
    ids = ids - vs.offset
    own = ((ids >= 0) & (ids < vs.size))[..., None]
    rows = params["embed"][ids.clamp(0, vs.size - 1)]
    rows = torch.where(own, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return all_reduce_sum(rows, vs).to(torch_dtype(cfg.compute_dtype))


def lm_logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
              gather: bool = True) -> torch.Tensor:
    """hidden [.., d] -> logits [.., padded_vocab], padded region masked.
    Split on vocab, each rank computes its columns (masked by their global
    index) and the columns are gathered; ``gather=False`` returns this
    rank's columns (the vocab-parallel loss).  Backward, ``hidden`` enters
    the column shards through ``to_local_region``."""
    vs = shard_of("vocab", cfg.padded_vocab)
    hidden = to_local_region(hidden, vs)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ w.to(hidden.dtype)
    first_pad = cfg.vocab_size - vs.offset          # local index of the first padded column
    if first_pad < vs.size:
        logits[..., max(first_pad, 0):] = NEG_INF
    return all_gather(logits, -1, vs) if gather else logits


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
    mesh, rules = active_mesh(), active_rules()
    for i in range(seg.count):
        layer_p = tree_map(lambda a: a[i], seg_params)
        cache_l = None if cache_seg is None else {k: t[i] for k, t in cache_seg.items()}
        lctx = dataclasses.replace(ctx, cache=cache_l)
        if remat:
            # the layer's own tree and context, bound now: the recompute
            # runs in the backward, after this loop has moved on (on CUDA,
            # on autograd's device thread: under the mesh active here)
            x, aux = checkpoint(_remat_layer(cfg, seg, layer_p, lctx, mesh, rules), x,
                                use_reentrant=False)
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


def _remat_layer(cfg: ModelConfig, seg: Segment, layer_p: dict, lctx: BlockCtx, mesh, rules):
    """One layer as ``checkpoint`` runs it -> (x, aux); under ``mesh`` and
    ``rules`` where a DeviceMesh is active (the recompute reads its shards)."""
    def run(x_):
        if not is_device_mesh(mesh):
            return block_apply(cfg, seg, layer_p, x_, lctx)[0::2]
        with use_mesh(mesh, rules):
            return block_apply(cfg, seg, layer_p, x_, lctx)[0::2]
    return run


def _temporal_is_index(positions: torch.Tensor) -> bool:
    """Whether the temporal row of [B, 3, S] positions is ``0..S-1`` in
    every row.  Positions the caller built on the host are checked there;
    positions already on the card cost one host read.  Meta positions (the
    dry run) have no values: they take the plain route, which any positions
    may take."""
    if positions.is_meta:
        return False
    t = positions[:, 0]
    return bool((t == torch.arange(t.shape[1], dtype=t.dtype, device=t.device)).all())


def _input_hidden(cfg: ModelConfig, params: dict, batch: dict):
    """(x [B,S',d], positions [B,S'] or [B,3,S'], index) with the meta-token
    prefix ahead of the input (S' = num_meta_tokens + S): the prefix takes
    positions 0..m-1 and the input's positions move up by m.  ``index``
    says the mask positions are ``0..S'-1`` in every row (the caller passed
    none, or M-RoPE positions whose temporal row is the index), which the
    flash_attention prefill needs."""
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(torch_dtype(cfg.compute_dtype))
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        index = True
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    else:
        positions = torch.as_tensor(positions)
        index = positions.dim() == 3 and _temporal_is_index(positions)
        positions = positions.to(x.device)
    m = cfg.num_meta_tokens
    if m:
        meta = params["meta_tokens"].to(x.dtype).expand(b, m, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        mpos = torch.arange(m, dtype=positions.dtype, device=positions.device)
        mpos = mpos.expand(positions.shape[:-1] + (m,))
        positions = torch.cat([mpos, positions + m], dim=-1)
    return x, positions, index


def _encode(cfg: ModelConfig, params: dict, batch: dict, mode: str):
    """Encoder stack over the stub frame embeddings -> (memory [B,Sm,d],
    its positions).  In a prefill its attention runs the flash_attention
    kernel without the causal mask; in training, the plain attention."""
    x = batch["src_embeds"].to(torch_dtype(cfg.compute_dtype))
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    ctx = BlockCtx(mode=mode, positions=positions, default_positions=True)
    for i, seg in enumerate(cfg.encoder_plan()):
        x, _, _ = _run_segment(cfg, seg, params["encoder"][i], x, ctx, None)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps), positions


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
    params = cast_params(cfg, params)
    memory = memory_pos = None
    if cfg.is_encdec:
        memory, memory_pos = _encode(cfg, params, batch, "train")
    x, positions, _ = _input_hidden(cfg, params, batch)
    ctx = BlockCtx(mode="train", positions=positions, memory=memory,
                   memory_positions=memory_pos)
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
               device="cuda", memory_len: Optional[int] = None) -> list:
    """Stacked per-segment caches sized for ``seq_len`` total positions; an
    encoder-decoder's cross-attention segments add ``xk`` / ``xv`` [count,
    batch, memory_len, KVH, D] (``prefill`` fills them)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.compute_dtype)
    caches = []
    for seg in cfg.decoder_plan():
        layer = block_cache_init(cfg, seg, batch, seq_len, dt, dev)
        stacked = {k: t.unsqueeze(0).repeat((seg.count,) + (1,) * t.dim())
                   for k, t in layer.items()}
        if cfg.is_encdec and seg.kind == "xdecoder":
            shape = (seg.count, batch, memory_len or seq_len, cfg.num_kv_heads,
                     cfg.head_dim)
            stacked["xk"] = torch.zeros(shape, dtype=dt, device=dev)
            stacked["xv"] = torch.zeros(shape, dtype=dt, device=dev)
        caches.append(stacked)
    return caches


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: list
            ) -> Tuple[torch.Tensor, list]:
    """Run the prompt, writing caches.  Returns (last hidden [B,d], cache)."""
    params = cast_params(cfg, params)
    memory = memory_pos = None
    if cfg.is_encdec:
        memory, memory_pos = _encode(cfg, params, batch, "prefill")
        cache = _fill_cross_kv(cfg, params, cache, memory)
    x, positions, index = _input_hidden(cfg, params, batch)
    if any(seg.has_attention for seg in cfg.decoder_plan()):
        prefill_routes["kernel" if index else "plain"] += 1
    ctx = BlockCtx(mode="prefill", positions=positions, default_positions=index,
                   memory=memory, memory_positions=memory_pos)
    new_caches = []
    for i, seg in enumerate(cfg.decoder_plan()):
        x, nc, _ = _run_segment(cfg, seg, params["segments"][i], x, ctx, cache[i])
        new_caches.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1], new_caches


def _fill_cross_kv(cfg: ModelConfig, params: dict, cache: list, memory) -> list:
    """Each cross-attention layer's memory KV -> the cache's ``xk`` / ``xv``
    (new tensors of the memory's length, as the JAX package stores them).
    Under a mesh each rank computes its ``wk`` / ``wv`` columns: they are its
    KV heads of the cache where the mesh splits the KV heads; where it
    splits only their columns (a shard cuts a head), they are gathered to
    the whole cache."""
    b, sm, _ = memory.shape
    kvs = shard_of("kv_heads", cfg.num_kv_heads * cfg.head_dim)
    kh = shard_of("kv_heads", cfg.num_kv_heads)
    out = []
    for i, seg in enumerate(cfg.decoder_plan()):
        c = dict(cache[i])
        if seg.kind == "xdecoder":
            p = params["segments"][i]["xattn"]
            for name, w in (("xk", p["wk"]), ("xv", p["wv"])):
                kv = [memory @ w[l] for l in range(seg.count)]
                if not kh.split:
                    kv = [all_gather(t, -1, kvs) for t in kv]
                c[name] = torch.stack([t.reshape(b, sm, kh.size, cfg.head_dim)
                                       for t in kv]).to(c[name].dtype)
        out.append(c)
    return out


def decode_step(cfg: ModelConfig, params: dict, cache: list,
                tokens: torch.Tensor, cur_pos: torch.Tensor,
                seq_len: Optional[int] = None) -> Tuple[torch.Tensor, list]:
    """One decode step.  tokens: [B] int32; cur_pos: [B] absolute position
    (all three M-RoPE components take it).  ``seq_len``: the contiguous
    cache's global length (``init_cache``'s), given where the cache may be
    split over the mesh by sequence (the decode cell); None: the cache is
    whole.

    ``cache`` is contiguous ({k, v, pos}, plus an encoder-decoder's {xk,
    xv}) or paged ({k_pool, v_pool, table, len}); paged attention runs the
    CUDA kernel for CUDA tensors and the plain version for CPU tensors.
    Returns (logits [B, padded_vocab], cache).
    """
    params = cast_params(cfg, params)
    b = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens[:, None])
    if cfg.mrope_sections is not None:
        positions = cur_pos[:, None, None].expand(b, 3, 1)
    else:
        positions = cur_pos[:, None]
    ctx = BlockCtx(mode="decode", positions=positions, cur_pos=cur_pos, seq_len=seq_len)
    if cfg.mrope_sections is not None and "pos" in cache[0]:
        # the first free slot, which every layer's write takes
        seg = cfg.decoder_plan()[0]
        ctx = dataclasses.replace(ctx, fill=first_free_slot(cfg, seg, cache[0]["pos"][0], ctx))
    new_caches = []
    for i, seg in enumerate(cfg.decoder_plan()):
        x, nc, _ = _run_segment(cfg, seg, params["segments"][i], x, ctx, cache[i])
        new_caches.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x[:, 0]), new_caches

"""PyTorch port: the xLSTM, qwen2-vl (M-RoPE) and seamless
(encoder-decoder) cells tensor-parallel over ``model`` > 1, and decode
cells whose cache the rules split by KV heads, over 4 gloo ranks on the
CPU, against the JAX package's jitted ``build_cell`` on the same mesh
shapes; and the gradients of the split mLSTM block, the sLSTM's FFN and
the cross-attention against one process's autograd.

One spawn of 4 ranks runs every case and writes what each rank holds; one
JAX subprocess per architecture and cell kind (this file run as a script,
with 4 host devices forced, XLA at optimisation level 0) writes the
reference's results; they all run at once, and the tests compare.  Meshes
of 2 ranks are built twice over the 4 (a leading ``rep`` dimension, sliced
off), so every rank works in every case.

Cases, fp32 smoke configs, on (1, 2), (1, 4) and (2, 2) ``("data",
"model")``:

* ``xlstm-smoke`` (3 mLSTM blocks of ``d_inner`` 64 split over
  ``ssm_inner``, then an sLSTM block whose FFN of 42 splits over 2 ranks
  and stays whole over 4; the sLSTM's conv state split by channel in the
  cache, as the reference's specs split it);
* ``qwen2vl-smoke`` (7 heads padded to 8 over 1 KV head, so every ``KV·D``
  shard cuts it; qkv bias; M-RoPE sections 4 / 2 / 2): a prompt whose
  temporal row is the index (the kernel route) and height / width rows
  that differ;
* ``seamless-smoke`` (4 heads over 4 KV heads; 2 encoder layers over 10
  frames, 2 decoder layers with cross-attention; its memory KV split by KV
  heads in the cache).

Each case runs the prefill cell over a 12-token prompt into a 16-position
cache, then 4 greedy steps of the decode cell, then 3 AdamW steps of the
train cell on a 4 x 16 batch (qwen2-vl's with an image block in its
positions, seamless's over 12 frames).  Held within 2e-5 (relative to the
norm of the reference's), as ``test_torch_tp_zoo.py`` holds them: the
logits and every cache shard at the rank's mesh coordinate, the greedy
tokens equal; each step's loss and gradient norm; each param shard after
the steps and its ``m`` / ``sqrt(v)`` shards after the first step (the
first gradient), per leaf; the moments after the steps over the whole
tree.  The replicated train leaves and the xLSTM's replicated cache
entries (the cell states) are bitwise equal across ``model`` ranks.

Why xLSTM's params after the steps are held over the whole tree: AdamW's
first update divides each element's gradient by its own magnitude, so an
element whose gradient is near zero moves by up to the learning rate
whichever way fp32 rounding tips it, and the mLSTM's ``wq`` and the
sLSTM's gate biases (``b_zifo``) hold such elements.  The reference's
jitted cell on (1, 2), (1, 4) and (2, 2) is itself 5.8e-5, 6.5e-5 and
6.8e-5 (of the leaf's norm) off its own single-device steps at ``b_zifo``
after three steps, and this port's one-process ``train_step`` 6.2e-5 off
them at ``wq``: over the limit with no mesh at all.  The first gradient,
which the per-leaf check holds, agrees to fp32 rounding.

A decode cache split by KV heads: the decode cell at a cache length of 17,
which neither 2 nor 4 divides, so the rules put ``model`` on the KV heads:
``llama3-smoke`` (8 heads over 2 KV heads) on (1, 2) and (2, 2),
``qwen2-smoke`` (6 heads padded to 8 over 2: rank 0's KV head serves heads
0-2 and the padded 6-7, which are not its own) on (1, 2),
``mixtral-smoke`` with a window of 7 (its ring cache of 7 positions split
by KV heads) on (1, 2), ``seamless-smoke`` on (1, 2) and (1, 4); prefill and
4 greedy steps held as above.

qwen2-vl with an image block (a 2 x 2 block between 4 text tokens on each
side): the reference indexes its cache by temporal position (ROADMAP.md,
divergences of the reference), so the prefill's logits are held against
the reference, and its cache and 4 decode steps against the port's own
single-process ``T.prefill`` / ``T.decode_step`` on the rank's rows.

Gradients over 2 ranks, fp64 inputs, each against autograd on the whole
tensors in one process, the loss whole on every rank, within 1e-6: the
mLSTM block split over ``ssm_inner``; the sLSTM block with its FFN split;
the cross-attention in training, its memory KV from ``wk`` / ``wv``
shards gathered to whole KV heads (one KV head a rank, and one KV head cut
in two).
"""

import dataclasses
import functools
import math
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORLD = 4
DEADLINE_S = 150

MESHES = {
    "1x2": ((1, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
REST = ("xlstm-1.3b", "qwen2-vl-7b", "seamless-m4t-medium")      # their smoke configs
CASES = [(a, m) for a in REST for m in MESHES]
HEAD_CACHE_CASES = [("llama3-8b", "1x2"), ("llama3-8b", "2x2"), ("qwen2-1.5b", "1x2"),
                    ("mixtral-8x7b", "1x2"), ("seamless-m4t-medium", "1x2"),
                    ("seamless-m4t-medium", "1x4")]
OVERRIDES = {"mixtral-8x7b": dict(sliding_window=7)}
VLM, XLSTM = "qwen2-vl-7b", "xlstm-1.3b"
B, PROMPT, STEPS, FRAMES = 2, 12, 4, 10      # serve: batch, prompt, greedy steps, frames
SEQ, ODD_SEQ = PROMPT + STEPS, PROMPT + STEPS + 1
IMAGE_TEXT, IMAGE_GRID = 4, 2                # 4 text, a 2 x 2 block, 4 text: 12 tokens
TB, TS, TSTEPS, TFRAMES, LR = 4, 16, 3, 12, 3e-3
TOL = 2e-5
GRAD_TOL = 1e-6
GRAD_CASES = ("mlstm", "slstm_ffn", "xattn", "xattn_cut")


# ------------------------------------------------------- shared inputs


def configure(cfg, arch):
    return dataclasses.replace(cfg, **OVERRIDES.get(arch, {}))


def draw_params(leaves, cfg_heads, seed=0):
    """Numpy weights for the (shape, logical axes) leaves in JAX order: norm
    gains (one named axis, ``embed`` or ``ssm_inner``) 1 + 0.1 N, everything
    else 0.05 N; the rows of padded query heads in ``wo`` zero, as the JAX
    package's init leaves them."""
    num_heads, head_dim = cfg_heads
    rng = np.random.default_rng(seed)
    out = []
    for shape, axes in leaves:
        named = [a for a in axes if a is not None]
        if named in (["embed"], ["ssm_inner"]) and axes[-1] in ("embed", "ssm_inner"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.05 * rng.standard_normal(shape)
        if axes[-2:] == ("heads", "embed"):
            a[..., num_heads * head_dim:, :] = 0.0
        out.append(a.astype(np.float32))
    return out


def image_block_positions(b, text, grid):
    """Qwen2-VL's position rule: ``text`` tokens, a ``grid`` x ``grid``
    image block at one temporal position spanning the grid in height and
    width, then ``text`` tokens past the block's largest position."""
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    block = np.stack([np.full(grid * grid, text), text + hh.ravel(), text + ww.ravel()])
    after = np.arange(text + grid, 2 * text + grid)
    pos = np.concatenate([np.tile(np.arange(text), (3, 1)), block, np.tile(after, (3, 1))],
                         axis=1)
    return np.broadcast_to(pos, (b, 3, pos.shape[1])).astype(np.int32).copy()


def text_positions(b, s, rng):
    """The temporal row ``0..s-1`` (the kernel route); height and width rows
    that differ from it."""
    pos = np.empty((b, 3, s), np.int32)
    pos[:, 0] = np.arange(s)
    pos[:, 1:] = rng.integers(0, s, size=(b, 2, s))
    return pos


def serve_batch(cfg, image=False):
    """The prefill cell's numpy batch: a 12-token prompt (embeddings and
    positions under M-RoPE) and an encoder-decoder's frames."""
    rng = np.random.default_rng(1)
    if cfg.input_mode == "embeds":
        batch = {"embeds": rng.standard_normal((B, PROMPT, cfg.d_model)).astype(np.float32),
                 "positions": (image_block_positions(B, IMAGE_TEXT, IMAGE_GRID) if image
                               else text_positions(B, PROMPT, rng))}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)}
    if cfg.is_encdec:
        batch["src_embeds"] = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def first_decode_pos(batch) -> int:
    """The position of the first decoded token: past the prompt's largest."""
    return int(batch["positions"].max()) + 1 if "positions" in batch else PROMPT


def train_batches(cfg):
    rng = np.random.default_rng(2)
    out = []
    for _ in range(TSTEPS):
        t = rng.integers(0, cfg.vocab_size, size=(TB, TS + 1)).astype(np.int32)
        batch = {"labels": t[:, 1:]}
        if cfg.input_mode == "embeds":
            batch["embeds"] = rng.standard_normal((TB, TS, cfg.d_model)).astype(np.float32)
            batch["positions"] = image_block_positions(TB, 6, 2)
        else:
            batch["tokens"] = t[:, :-1]
        if cfg.is_encdec:
            batch["src_embeds"] = rng.standard_normal((TB, TFRAMES, cfg.d_model)).astype(
                np.float32)
        out.append(batch)
    return out


def coord_key(coord) -> str:
    return "".join(str(int(c)) for c in coord)


# ------------------------------------------------------------- the ranks


@functools.lru_cache(maxsize=None)
def rank_mesh(shape, names):
    """A DeviceMesh of ``shape``; when it has fewer ranks than the world,
    one per block of ranks (a leading ``rep`` dimension, sliced off).  Made
    once a shape: each makes its process groups."""
    from torch.distributed.device_mesh import DeviceMesh

    reps = WORLD // math.prod(shape)
    full = DeviceMesh("cpu", torch.arange(WORLD).reshape((reps,) + tuple(shape)),
                      mesh_dim_names=("rep",) + tuple(names))
    return full[tuple(names)]


def smoke(arch):
    """(cfg, whole params as torch tensors)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.interop import from_numpy, tree_flatten, tree_unflatten
    from repro_torch.models.transformer import param_specs

    cfg = configure(get_smoke_config(arch), arch)
    specs, treedef = tree_flatten(param_specs(cfg))
    leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                         (cfg.num_heads, cfg.head_dim))
    return cfg, tree_unflatten(treedef, [from_numpy(a) for a in leaves])


def serve_key(arch, mname, image=False, head_cache=False) -> str:
    return f"{arch}/{mname}" + ("/image" if image else "") + ("/heads" if head_cache else "")


def rank_serve(out, arch, mname, image=False, head_cache=False):
    """The prefill cell, then STEPS greedy decode-cell steps (the cache
    ODD_SEQ long with ``head_cache``); with ``image``, the same again in
    one process on this rank's rows and whole params, its cache at the
    rank's coordinate."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import gather_shard, use_mesh
    from repro_torch.interop import from_numpy, to_numpy, tree_flatten, tree_map
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import transformer as T
    from repro_torch.models.common import is_tuple

    cfg, params = smoke(arch)
    mesh = rank_mesh(*MESHES[mname])
    key = serve_key(arch, mname, image, head_cache)
    out[f"{arch}/{mname}/coord"] = np.asarray(mesh.get_coordinate())
    seq = ODD_SEQ if head_cache else SEQ

    with use_mesh(mesh, rules_for("prefill", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("p", seq, B, "prefill"), mesh)
    p_local = SP.local_tree(params, cell.in_specs[0], mesh)
    np_batch = serve_batch(cfg, image)
    batch = SP.local_tree({k: from_numpy(v) for k, v in np_batch.items()}, cell.in_specs[1],
                          mesh)
    logits, cache = cell.fn(p_local, batch)
    out[f"{key}/prefill/logits"] = to_numpy(logits)
    for i, t in enumerate(tree_flatten(cache)[0]):
        out[f"{key}/prefill/cache{i}"] = to_numpy(t)
    full_cache = tree_map(lambda t, s: gather_shard(t, s, mesh), cache, cell.out_specs[1],
                          is_leaf=is_tuple)

    with use_mesh(mesh, rules_for("decode", cfg)):
        dcell = SP.build_cell(cfg, ShapeConfig("d", seq, B, "decode"), mesh)
    p_local = SP.local_tree(params, dcell.in_specs[0], mesh)
    cache = SP.local_tree(full_cache, dcell.in_specs[1], mesh)
    tokens = logits.argmax(dim=-1).to(torch.int32)
    toks = [tokens]
    pos0 = first_decode_pos(np_batch)
    for step in range(STEPS):
        cur = torch.full_like(tokens, pos0 + step)
        logits, cache = dcell.fn(p_local, cache, tokens, cur)
        out[f"{key}/decode{step}/logits"] = to_numpy(logits)
        tokens = logits.argmax(dim=-1).to(torch.int32)
        toks.append(tokens)
    out[f"{key}/tokens"] = to_numpy(torch.stack(toks, dim=1))
    for i, t in enumerate(tree_flatten(cache)[0]):
        out[f"{key}/decode/cache{i}"] = to_numpy(t)
    if not image:
        return
    # the port in one process on this rank's rows, fed the same tokens
    rows = {k: v for k, v in batch.items()}
    b = rows["embeds"].shape[0]
    single = T.init_cache(cfg, b, seq, torch.float32, device="cpu")
    hidden, single = T.prefill(cfg, params, rows, single)
    out[f"{key}/single/prefill/logits"] = to_numpy(T.lm_logits(cfg, params, hidden))
    local = SP.local_tree(single, SP._unbatched(cell.out_specs[1]), mesh)
    for i, t in enumerate(tree_flatten(local)[0]):
        out[f"{key}/single/prefill/cache{i}"] = to_numpy(t)
    for step in range(STEPS):
        lg, single = T.decode_step(cfg, params, single, toks[step],
                                   torch.full_like(toks[step], pos0 + step))
        out[f"{key}/single/decode{step}/logits"] = to_numpy(lg)


def rank_train(out, arch, mname):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import from_numpy, to_numpy, tree_flatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.common import is_tuple
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import TrainConfig

    cfg, full = smoke(arch)
    tcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=LR, warmup_steps=1))
    mesh = rank_mesh(*MESHES[mname])
    with use_mesh(mesh, rules_for("train", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("t", TS, TB, "train"), mesh, tcfg)
    p_specs, o_specs, b_specs = cell.in_specs
    params = SP.local_tree(full, p_specs, mesh)
    state = SP.local_tree(init_state(full), o_specs, mesh)
    key = f"{arch}/{mname}/train"
    losses, norms = [], []
    for step, batch in enumerate(train_batches(cfg)):
        batch = SP.local_tree({k: from_numpy(v) for k, v in batch.items()}, b_specs, mesh)
        params, state, metrics = cell.fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if step == 0:
            for name, tree in (("m1_", state.m), ("v1_", state.v)):
                for i, t in enumerate(tree_flatten(tree)[0]):
                    out[f"{key}/{name}{i}"] = to_numpy(t)
    out[f"{key}/loss"] = np.asarray(losses)
    out[f"{key}/grad_norm"] = np.asarray(norms)
    out[f"{key}/step"] = np.asarray(int(state.step))
    out[f"{key}/split"] = np.asarray([any(e is not None for e in s)
                                      for s in tree_flatten(p_specs, is_tuple)[0]])
    for name, tree in (("p", params), ("m", state.m), ("v", state.v)):
        for i, t in enumerate(tree_flatten(tree)[0]):
            out[f"{key}/{name}{i}"] = to_numpy(t)


def rel(a, b, scale=None) -> float:
    """||a - b|| over the norm of ``scale`` (default ``b``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = b if scale is None else np.asarray(scale, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(scale), 1e-30))


def grad_case(name):
    """(whole fp64 params, their logical axes, x, fn, outputs split over
    ``ssm_inner`` by index): ``fn(params, x)`` under the active mesh ->
    (loss, outputs held beside the gradients).  Without a mesh it is the
    whole function the ranks are held to."""
    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.tensor_parallel import shard_of
    from repro_torch.interop import tree_flatten, tree_unflatten
    from repro_torch.models import blocks, xlstm
    from repro_torch.models.common import ParamSpec

    rng = np.random.default_rng(21)
    if name == "mlstm":
        d, heads, d_inner = 16, 2, 32
        specs = xlstm.mlstm_block_specs(d, heads, 2.0, 0.5, 4)
        x_shape = (2, 12, d)
    elif name == "slstm_ffn":
        d, heads = 24, 2                                 # d_ff 32
        specs = xlstm.slstm_block_specs(d, heads)
        x_shape = (2, 12, d)
    else:
        # 4 heads over 2 KV heads (one a rank), or 3 padded to 4 over 1 KV
        # head (its KV·D cut in two)
        heads, kvh = (4, 2) if name == "xattn" else (3, 1)
        cfg = get_smoke_config("seamless-m4t-medium").replace(
            d_model=24, num_heads=heads, num_kv_heads=kvh, head_dim=6)
        specs = {"attn": blocks.attn_param_specs(cfg),
                 "mem": ParamSpec((2, 9, 24), (None, None, None), None)}
        x_shape = (2, 7, 24)
    leaves, treedef = tree_flatten(specs)
    params = tree_unflatten(treedef, [torch.from_numpy(0.3 * rng.standard_normal(s.shape))
                                      for s in leaves])
    axes = tree_unflatten(treedef, [s.logical_axes for s in leaves])
    x = torch.from_numpy(rng.standard_normal(x_shape))
    cot = torch.from_numpy(rng.standard_normal(x_shape))

    if name == "mlstm":
        def fn(p, x_):
            y, (state, conv) = xlstm.mlstm_block_forward(
                p, x_, heads, chunk_size=4, shard=shard_of("ssm_inner", d_inner))
            return (y * cot).sum(), [y, *state, conv]
        return params, axes, x, fn, {4: d_inner}
    if name == "slstm_ffn":
        def fn(p, x_):
            y, (state, conv) = xlstm.slstm_block_forward(
                p, x_, heads, ffn=shard_of("ffn", xlstm.slstm_d_ff(d)))
            return (y * cot).sum(), [y, *state, conv]
        return params, axes, x, fn, {}

    def fn(p, x_):
        b, s, _ = x_.shape
        sm = p["mem"].shape[1]
        ctx = blocks.BlockCtx(
            mode="train", positions=torch.arange(s).expand(b, s), memory=p["mem"],
            memory_positions=torch.arange(sm).expand(b, sm))
        y, _ = blocks.attn_apply(cfg, Segment("xdecoder", 1, 0), p["attn"], x_, ctx,
                                 cross=True)
        return (y * cot).sum(), [y]
    return params, axes, x, fn, {}


def rank_grads(out):
    """Each gradient case on a (1, 2) mesh: this rank's shards of the
    params, the whole input, the loss whole on every rank; its gradients
    against autograd on the whole tensors in this process.  Outputs split
    over ``ssm_inner`` (the mLSTM's conv state) are held at the rank's
    slice."""
    from repro_torch.distributed.sharding import logical_pspec, shard_slices, use_mesh
    from repro_torch.distributed.tensor_parallel import shard_of
    from repro_torch.interop import tree_flatten, tree_map
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.common import is_tuple

    mesh = rank_mesh((1, 2), ("data", "model"))
    for name in GRAD_CASES:
        params, axes, x, fn, split_outs = grad_case(name)
        whole = tree_map(lambda t: t.clone().requires_grad_(True), params)
        xw = x.clone().requires_grad_(True)
        loss, want = fn(whole, xw)
        loss.backward()
        with use_mesh(mesh, rules_for("train")):
            specs = tree_map(lambda a, t: logical_pspec(a, t.shape, mesh), axes, params,
                             is_leaf=is_tuple)
            local = tree_map(lambda t, s: t[shard_slices(s, t.shape, mesh)].clone()
                             .requires_grad_(True), params, specs, is_leaf=is_tuple)
            xl = x.clone().requires_grad_(True)
            got_loss, got = fn(local, xl)
            got_loss.backward()
            chans = {i: shard_of("ssm_inner", n).slice for i, n in split_outs.items()}
        errs = {"loss": rel(got_loss.detach(), loss.detach()), "x": rel(xl.grad, xw.grad)}
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.detach(), w.detach()
            if i in chans:
                w = w[..., chans[i]]
            errs[f"out{i}"] = rel(g, w) if w.abs().sum() > 0 else float((g - w).abs().max())
        split = 0
        for i, (g, w, s) in enumerate(zip(tree_flatten(local)[0], tree_flatten(whole)[0],
                                          tree_flatten(specs, is_tuple)[0])):
            errs[f"p{i}"] = rel(g.grad, w.grad[shard_slices(s, w.shape, mesh)])
            split += any(e is not None for e in s)
        out[f"grad/{name}/errs"] = np.asarray(list(errs.values()))
        out[f"grad/{name}/names"] = np.asarray(list(errs))
        out[f"grad/{name}/split_leaves"] = np.asarray(split)


def rank_main(rank, world, pg_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_path}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=DEADLINE_S))
    try:
        out = {}
        rank_grads(out)
        for arch, mname in CASES:
            rank_serve(out, arch, mname)
            if arch == VLM:
                rank_serve(out, arch, mname, image=True)
            rank_train(out, arch, mname)
        for arch, mname in HEAD_CACHE_CASES:
            rank_serve(out, arch, mname, head_cache=True)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the reference


def port_layout(cfg, cache):
    """The reference's cache in the port's layout: an xLSTM layer's state
    tuple under one name per tensor."""
    names = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "m", "h")}
    out = []
    for seg, c in zip(cfg.decoder_plan(), cache):
        if seg.kind in names:
            c = {"conv": c["conv"], **dict(zip(names[seg.kind], c["state"]))}
        out.append(c)
    return out


def reference_main(path, group, kind):
    """The JAX package's jitted cells (run as a script, 4 host devices):
    ``group`` an architecture of REST or "heads" (HEAD_CACHE_CASES);
    ``kind`` "serve" runs the prefill cell and the decode cell's greedy
    steps (qwen2-vl's image-block prompt: the prefill only), "train" the
    train cell's steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import repro.launch.specs as RSP
    import repro.train.optimizer as ropt
    import repro.train.train_step as rts
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.distributed.sharding import use_mesh
    from repro.launch.mesh import rules_for
    from repro.models.common import ParamSpec
    from repro.models.transformer import param_specs

    out = {}
    devs = np.array(jax.devices()[:WORLD])

    def shards(prefix, tree, mesh):
        pos = {dev.id: idx for idx, dev in np.ndenumerate(mesh.devices)}
        for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
            out[f"{prefix}{i}"] = np.asarray(leaf)
            for shard in leaf.addressable_shards:
                out[f"{prefix}{i}@{coord_key(pos[shard.device.id])}"] = np.asarray(shard.data)

    def serve(cfg, params, mesh, key, seq, image=False):
        batch = serve_batch(cfg, image)
        with use_mesh(mesh, rules_for("prefill", cfg)):
            fn, _ = RSP.build_cell(cfg, ShapeConfig("p", seq, B, "prefill"), mesh)
            logits, cache = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
        out[f"{key}/prefill/logits"] = np.asarray(logits)
        if image:           # the reference's image-block cache is its fault's
            return
        shards(f"{key}/prefill/cache", port_layout(cfg, cache), mesh)
        cache = jax.tree_util.tree_map(np.asarray, cache)
        pos0 = first_decode_pos(batch)
        with use_mesh(mesh, rules_for("decode", cfg)):
            dfn, _ = RSP.build_cell(cfg, ShapeConfig("d", seq, B, "decode"), mesh)
            toks = [np.asarray(jnp.argmax(logits, axis=-1).astype(jnp.int32))]
            for step in range(STEPS):
                cur = np.full((B,), pos0 + step, np.int32)
                logits, cache = dfn(params, cache, toks[-1], cur)
                out[f"{key}/decode{step}/logits"] = np.asarray(logits)
                toks.append(np.asarray(jnp.argmax(logits, axis=-1).astype(jnp.int32)))
                if step < STEPS - 1:
                    cache = jax.tree_util.tree_map(np.asarray, cache)
        out[f"{key}/tokens"] = np.stack(toks, axis=1)
        shards(f"{key}/decode/cache", port_layout(cfg, cache), mesh)

    def train(cfg, params, mesh, key):
        tcfg = rts.TrainConfig(optimizer=ropt.AdamWConfig(learning_rate=LR, warmup_steps=1))
        with use_mesh(mesh, rules_for("train", cfg)):
            step, _ = RSP.build_cell(cfg, ShapeConfig("t", TS, TB, "train"), mesh, tcfg)
            # the first step's arguments on the shardings its outputs take,
            # so every step runs the one compiled program
            sh = lambda tree: jax.tree.map(  # noqa: E731
                lambda p: NamedSharding(mesh, p), tree,
                is_leaf=lambda v: isinstance(v, PartitionSpec))
            params = jax.device_put(params, sh(RSP.param_pspecs(cfg, mesh)))
            state = jax.device_put(ropt.init_state(params), sh(RSP.opt_pspecs(cfg, mesh)))
            losses, norms = [], []
            for i, batch in enumerate(train_batches(cfg)):
                params, state, metrics = step(params, state,
                                              {k: jnp.asarray(v) for k, v in batch.items()})
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
                if i == 0:
                    shards(f"{key}/train/m1_", state.m, mesh)
                    shards(f"{key}/train/v1_", state.v, mesh)
        out[f"{key}/train/loss"] = np.asarray(losses)
        out[f"{key}/train/grad_norm"] = np.asarray(norms)
        for name, tree in (("p", params), ("m", state.m), ("v", state.v)):
            shards(f"{key}/train/{name}", tree, mesh)

    cases = (HEAD_CACHE_CASES if group == "heads"
             else [(a, m) for a, m in CASES if a == group])
    for arch, mname in cases:
        cfg = configure(get_smoke_config(arch), arch)
        specs, treedef = jax.tree_util.tree_flatten(
            param_specs(cfg), is_leaf=lambda v: isinstance(v, ParamSpec))
        leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                             (cfg.num_heads, cfg.head_dim))
        shape, names = MESHES[mname]
        mesh = Mesh(devs[:math.prod(shape)].reshape(shape), names)
        params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
        if kind == "train":
            train(cfg, params, mesh, f"{arch}/{mname}")
        elif group == "heads":
            serve(cfg, params, mesh, serve_key(arch, mname, head_cache=True), ODD_SEQ)
        else:
            serve(cfg, params, mesh, serve_key(arch, mname), SEQ)
            if arch == VLM:
                serve(cfg, params, mesh, serve_key(arch, mname, image=True), SEQ, image=True)
    np.savez(path, **out)


# -------------------------------------------------------------- the run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference subprocesses (one per architecture and cell kind,
    and one for the caches split by KV heads; XLA's CPU backend at
    optimisation level 0) and the 4 ranks together; wait for all (within
    ``DEADLINE_S``); their results as dicts."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("tp_rest")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4"
                          + " --xla_backend_optimization_level=0").strip())
    jobs = [(arch, kind) for arch in REST for kind in ("serve", "train")] + [("heads", "serve")]
    refs = [subprocess.Popen([sys.executable, __file__, "reference", str(tmp / f"ref{i}.npz"),
                              group, kind], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i, (group, kind) in enumerate(jobs)]
    try:
        t0 = time.monotonic()
        ctx = mp.start_processes(rank_main, args=(WORLD, str(tmp / "pg"), str(tmp)),
                                 nprocs=WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(1.0, DEADLINE_S - (time.monotonic() - t0))):
                if time.monotonic() - t0 > DEADLINE_S:
                    pytest.fail(f"the ranks did not finish in {DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        for ref in refs:
            log, _ = ref.communicate(timeout=max(1.0, DEADLINE_S - (time.monotonic() - t0)))
            assert ref.returncode == 0, log
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    ref = {}
    for i in range(len(jobs)):
        ref.update(np.load(tmp / f"ref{i}.npz"))
    return ref, ranks


def batch_rows(mname, coord, batch):
    """This coordinate's rows of the batch (split over data)."""
    shape, names = MESHES[mname]
    n = dict(zip(names, shape))["data"]
    i = dict(zip(names, coord))["data"]
    return slice(i * batch // n, (i + 1) * batch // n)


def n_cache(ranks, key):
    return sum(1 for k in ranks[0] if k.startswith(key) and k[len(key):].isdigit())


def n_model(mname) -> int:
    return dict(zip(MESHES[mname][1], MESHES[mname][0]))["model"]


def hold_serve(ref, ranks, arch, mname, key):
    """Every rank's prefill and decode logits, greedy tokens and cache
    shards against the reference's at its coordinate."""
    n_prefill, n_decode = n_cache(ranks, f"{key}/prefill/cache"), n_cache(ranks, f"{key}/decode/cache")
    assert n_prefill == n_decode > 0
    for r in ranks:
        coord = r[f"{arch}/{mname}/coord"]
        rows = batch_rows(mname, coord, B)
        assert rel(r[f"{key}/prefill/logits"], ref[f"{key}/prefill/logits"][rows]) < TOL
        np.testing.assert_array_equal(r[f"{key}/tokens"], ref[f"{key}/tokens"][rows])
        for step in range(STEPS):
            assert rel(r[f"{key}/decode{step}/logits"],
                       ref[f"{key}/decode{step}/logits"][rows]) < TOL, step
        for phase, n in (("prefill", n_prefill), ("decode", n_decode)):
            for i in range(n):
                got = r[f"{key}/{phase}/cache{i}"]
                want = ref[f"{key}/{phase}/cache{i}@{coord_key(coord)}"]
                assert got.shape == want.shape, (phase, i, got.shape, want.shape)
                if got.dtype.kind == "i":                       # pos: exact
                    np.testing.assert_array_equal(got, want)
                else:
                    assert rel(got, want) < TOL, (phase, i)


@pytest.mark.parametrize("arch,mname", CASES)
def test_prefill_and_decode_cells_match_reference(runs, arch, mname):
    ref, ranks = runs
    hold_serve(ref, ranks, arch, mname, serve_key(arch, mname))


@pytest.mark.parametrize("arch,mname", CASES)
def test_cache_split_as_the_specs_say(runs, arch, mname):
    """Each decode-cache leaf's split over ``model``: the reference's shard
    shape at the rank's coordinate is the leaf's (held above), and the
    leaves split over ``model`` are the ones the architecture's path
    splits: the KV by sequence, the memory KV by KV heads, the conv states
    by channel; the xLSTM's cell states are whole on every rank."""
    ref, ranks = runs
    key = serve_key(arch, mname)
    n = n_model(mname)
    split = []
    for i in range(n_cache(ranks, f"{key}/decode/cache")):
        got = ranks[0][f"{key}/decode/cache{i}"]
        whole = ref[f"{key}/decode/cache{i}"]
        local_b = got.shape[1]
        split.append(math.prod(got.shape) * (B // local_b) * n == whole.size)
        assert split[-1] or math.prod(got.shape) * (B // local_b) == whole.size, i
    # xlstm: the mLSTM segment's C, conv, m, n; the sLSTM's c, conv, h, m, n
    want = {"xlstm-1.3b": [False, True, False, False] + [False, True, False, False, False],
            "qwen2-vl-7b": [True] * 3,                   # k, pos, v by sequence
            "seamless-m4t-medium": [True] * 5}           # + xk, xv by KV heads
    assert split == want[arch], split


@pytest.mark.parametrize("arch,mname", CASES)
def test_replicated_cache_entries_bitwise_across_model_ranks(runs, arch, mname):
    """Ranks that differ only in their ``model`` coordinate hold the same
    bits of every cache entry the specs do not split over ``model`` (the
    xLSTM's cell states; none in the others' decode caches)."""
    ref, ranks = runs
    key = serve_key(arch, mname)
    groups = {}
    for r in ranks:
        groups.setdefault(coord_key(r[f"{arch}/{mname}/coord"][:-1]), []).append(r)
    held = 0
    for i in range(n_cache(ranks, f"{key}/decode/cache")):
        got = ranks[0][f"{key}/decode/cache{i}"]
        if math.prod(got.shape) * (B // got.shape[1]) != ref[f"{key}/decode/cache{i}"].size:
            continue                                   # split over model
        for group in groups.values():
            for r in group[1:]:
                for phase in ("prefill", "decode"):
                    np.testing.assert_array_equal(r[f"{key}/{phase}/cache{i}"],
                                                  group[0][f"{key}/{phase}/cache{i}"])
        held += 1
    assert held == (7 if arch == "xlstm-1.3b" else 0)


@pytest.mark.parametrize("arch,mname", CASES)
def test_train_cell_matches_reference(runs, arch, mname):
    ref, ranks = runs
    key = f"{arch}/{mname}/train"
    np.testing.assert_allclose(ranks[0][f"{key}/loss"], ref[f"{key}/loss"], rtol=TOL)
    np.testing.assert_allclose(ranks[0][f"{key}/grad_norm"], ref[f"{key}/grad_norm"], rtol=TOL)
    n = len(ranks[0][f"{key}/split"])

    def held(r, name, i, at):
        got, want = r[f"{key}/{name}{i}"], ref[f"{key}/{name}{i}@{at}"]
        whole = ref[f"{key}/{name}{i}"]
        assert got.shape == want.shape, (name, i, got.shape, want.shape)
        if name.startswith("v"):        # in the gradients' units, as m
            return np.sqrt(got), np.sqrt(want), np.sqrt(whole)
        return got, want, whole

    for r in ranks:
        assert int(r[f"{key}/step"]) == TSTEPS
        np.testing.assert_array_equal(r[f"{key}/loss"], ranks[0][f"{key}/loss"])
        at = coord_key(r[f"{arch}/{mname}/coord"])
        # each leaf: the first gradient, and the params after the steps but xLSTM's
        for name in ("m1_", "v1_") + (() if arch == XLSTM else ("p",)):
            for i in range(n):
                err = rel(*held(r, name, i, at))
                assert err < TOL, (at, name, i, err)
        # the moments after the steps (and xLSTM's params), every leaf
        for name in ("m", "v") + (("p",) if arch == XLSTM else ()):
            diff = scale = 0.0
            for i in range(n):
                got, want, whole = (a.astype(np.float64) for a in held(r, name, i, at))
                diff += float(np.sum((got - want) ** 2))
                scale += float(np.sum(whole ** 2))
            err = math.sqrt(diff / scale)
            assert err < TOL, (at, name, err)


@pytest.mark.parametrize("arch,mname", CASES)
def test_train_replicated_leaves_bitwise_across_model_ranks(runs, arch, mname):
    """Ranks that differ only in their ``model`` coordinate hold the same
    bits of every replicated leaf and of its moments."""
    _, ranks = runs
    key = f"{arch}/{mname}/train"
    split = ranks[0][f"{key}/split"]
    assert split.any() and not split.all()
    groups = {}
    for r in ranks:
        groups.setdefault(coord_key(r[f"{arch}/{mname}/coord"][:-1]), []).append(r)
    peers = 0
    for group in groups.values():
        for r in group[1:]:
            for name in ("p", "m", "v"):
                for i in np.flatnonzero(~split):
                    np.testing.assert_array_equal(r[f"{key}/{name}{i}"],
                                                  group[0][f"{key}/{name}{i}"])
            peers += 1
    assert peers > 0


@pytest.mark.parametrize("arch,mname", HEAD_CACHE_CASES)
def test_decode_cache_split_by_kv_heads(runs, arch, mname):
    """A cache length of 17: the decode cell's KV split by KV heads (the
    heads dim of every k / v shard the whole's over ``model``, the
    positions whole), held against the reference as above."""
    ref, ranks = runs
    key = serve_key(arch, mname, head_cache=True)
    hold_serve(ref, ranks, arch, mname, key)
    n = n_model(mname)
    for i in range(n_cache(ranks, f"{key}/decode/cache")):
        got, whole = ranks[0][f"{key}/decode/cache{i}"], ref[f"{key}/decode/cache{i}"]
        if got.ndim == 5:                               # k, v (xk, xv): [L, B, S, KVH, D]
            assert got.shape[2] == whole.shape[2] and got.shape[3] * n == whole.shape[3], i
        else:                                           # pos: whole on every rank
            assert got.shape[2] == whole.shape[2], i


@pytest.mark.parametrize("mname", list(MESHES))
def test_image_block_prompt(runs, mname):
    """qwen2-vl with a 2 x 2 image block: the prefill cell's logits against
    the reference's; its cache shards and 4 decode-cell steps against the
    port's own prefill and decode steps in one process."""
    ref, ranks = runs
    key = serve_key(VLM, mname, image=True)
    for r in ranks:
        rows = batch_rows(mname, r[f"{VLM}/{mname}/coord"], B)
        assert rel(r[f"{key}/prefill/logits"], ref[f"{key}/prefill/logits"][rows]) < TOL
        assert rel(r[f"{key}/prefill/logits"], r[f"{key}/single/prefill/logits"]) < TOL
        n = n_cache(ranks, f"{key}/prefill/cache")
        assert n == 3
        for i in range(n):
            got, want = r[f"{key}/prefill/cache{i}"], r[f"{key}/single/prefill/cache{i}"]
            assert got.shape == want.shape, (i, got.shape, want.shape)
            if got.dtype.kind == "i":
                np.testing.assert_array_equal(got, want)
            else:
                assert rel(got, want) < TOL, i
        for step in range(STEPS):
            assert rel(r[f"{key}/decode{step}/logits"],
                       r[f"{key}/single/decode{step}/logits"]) < TOL, step


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_whole_autograd(runs, name):
    """The loss whole on every rank: each rank's param-shard gradients are
    the whole gradient's slice, and the gradients of ``x`` and of the
    replicated leaves (the memory of the cross-attention among them) the
    whole gradient."""
    _, ranks = runs
    for r in ranks:
        assert int(r[f"grad/{name}/split_leaves"]) > 0
        errs = dict(zip(r[f"grad/{name}/names"], r[f"grad/{name}/errs"]))
        assert all(e < GRAD_TOL for e in errs.values()), errs


@pytest.mark.parametrize("mname,ffn_split", [("1x2", True), ("1x4", False)])
def test_slstm_ffn_split_where_the_rules_give_it(mname, ffn_split):
    """xlstm-smoke's sLSTM FFN (d_ff 42) splits over 2 ranks and stays whole
    over 4, by the rules' divisibility; the mLSTM's channels split on both."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import MeshSpec, use_mesh
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for

    cfg = get_smoke_config("xlstm-1.3b")
    mesh = MeshSpec(*reversed(MESHES[mname]))
    with use_mesh(mesh, rules_for("train", cfg)):
        specs = SP.param_pspecs(cfg, mesh)["segments"]
    slstm = specs[-1]
    assert (slstm["w_up"][-1] == "model") == ffn_split
    assert (slstm["w_down"][-2] == "model") == ffn_split
    assert specs[0]["up_proj"][-1] == "model" and specs[0]["down_proj"][-2] == "model"


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2], sys.argv[3], sys.argv[4])

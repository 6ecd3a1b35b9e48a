"""PyTorch port: the train cell tensor-parallel over ``model`` > 1, over 4
gloo ranks on the CPU, against the JAX package's jitted ``build_cell`` train
step on the same mesh shapes; and the gradients of the tensor-parallel
collectives against one process's autograd.

One spawn of 4 ranks runs every case and writes what each rank holds; one
JAX subprocess per architecture (this file run as a script, with 4 host
devices forced, XLA at optimisation level 0) writes the reference's
results; they all run at once, and the tests compare.  Meshes of 2 ranks
are built twice over the 4 (a leading ``rep`` dimension, sliced off), so
every rank works in every case.

Train cases, fp32 smoke configs, global batch 4 x 16, three AdamW steps
(learning rate 3e-3 after one warm-up step, so the steps move the weights):

* ``llama3-smoke`` on (1, 2) and (2, 2) ``("data", "model")``: 8 heads over
  2 KV heads, one whole KV head a rank; on (2, 2) the batch and the ZeRO-1
  moments split over ``data`` too;
* ``qwen2-smoke`` on (1, 4): 6 heads padded to 8 over 2 KV heads, so a
  ``KV·D`` shard cuts a KV head and rank 3 holds padded heads only; tied
  vocabulary and QKV bias;
* ``smollm-smoke`` on (1, 4): 3 heads padded to 4, its one KV head cut four
  ways; tied vocabulary;
* ``deepseek-smoke`` on (2, 1, 2) ``("pod", "data", "model")``: MHA over 4
  KV heads, the batch over ``pod``, with a ``loss_mask`` whose shards hold
  unequal token counts (the reference's ``build_cell`` step re-jitted with
  the mask's sharding beside the labels').

Held: each step's loss and gradient norm within 2e-5 (relative), and each
rank's param shard and its ZeRO-1 ``m`` / ``sqrt(v)`` shards after the three
steps within 2e-5 of the reference's shards at the rank's mesh coordinate,
relative to the norm of the reference's whole leaf; the replicated leaves
(the norms) bitwise equal across ``model`` ranks.  Two choices of the
measure, both from the reference's own spread:

* the whole leaf's norm, not the shard's: qwen2's rank 3 holds padded heads
  only, whose ``bq`` / ``wq`` moments are ~5 % of the leaf's norm and sums
  of cancelling terms; the port's single-device ``train_step`` is itself
  6.1e-5 of that shard's norm from the reference there (4.4e-6 of the
  leaf's);
* ``v`` through its square root, in the gradients' units as ``m`` is:
  AdamW's first step divides gradients within a few ``eps`` of zero by
  their own size, so the reference's sharded and single-device runs differ
  by 6.7e-6 in deepseek's masked (28 loss tokens) ``lm_head`` ``v``, the
  port's single-device ``train_step`` by 1.2e-5, and this cell by 2.26e-5
  in ``v`` itself (half that in ``sqrt(v)``).

Collective gradients, over 2 ranks, each against autograd on the whole
tensors in one process, within 1e-6 (fp32, relative to the norm): a
column -> row split SwiGLU MLP; a GQA attention on head-split q with
replicated ``wk`` / ``wv`` (the rules' ``kv_heads`` mapped to nothing, the
case where ``KV·D`` does not divide over ``model``); an attention whose
head shard cuts a head (q gathered); the vocab-parallel loss with a padded
vocabulary and the z-loss.  With remat "full", the layers' recompute run
on a thread without the mesh (as autograd's CUDA device thread runs it):
the gradients bitwise those without remat.  And, without a mesh, every op
the identity, forward and backward.
"""

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

B, S, STEPS = 4, 16, 3
LR = 3e-3
MASK_LENGTHS = (16, 3, 9, 0)        # loss tokens per row: unequal shards, one empty
TRAIN_CASES = {                     # name: (arch, mesh shape, names, masked)
    "llama3_1x2": ("llama3-8b", (1, 2), ("data", "model"), False),
    "llama3_2x2": ("llama3-8b", (2, 2), ("data", "model"), False),
    "qwen2_1x4": ("qwen2-1.5b", (1, 4), ("data", "model"), False),
    "smollm_1x4": ("smollm-135m", (1, 4), ("data", "model"), False),
    "deepseek_2x1x2": ("deepseek-7b", (2, 1, 2), ("pod", "data", "model"), True),
}
TOL = 2e-5
GRAD_TOL = 1e-6
GRAD_CASES = ("mlp", "attn_replicated_kv", "attn_gathered_q", "loss")


# ------------------------------------------------------- shared inputs


def draw_params(leaves, cfg_heads, seed=0):
    """Numpy weights for the (shape, logical axes) leaves in JAX order: norms
    1 + 0.1 N, everything else 0.05 N; the rows of padded query heads in
    ``wo`` zero, as the JAX package's init leaves them."""
    num_heads, head_dim = cfg_heads
    rng = np.random.default_rng(seed)
    out = []
    for shape, axes in leaves:
        if all(a in (None, "embed") for a in axes):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.05 * rng.standard_normal(shape)
        if axes[-2:] == ("heads", "embed"):
            a[..., num_heads * head_dim:, :] = 0.0
        out.append(a.astype(np.float32))
    return out


def train_batches(vocab, masked):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if masked:
            batch["loss_mask"] = np.arange(S)[None, :] < np.asarray(MASK_LENGTHS)[:, None]
        out.append(batch)
    return out


def coord_key(coord) -> str:
    return "".join(str(int(c)) for c in coord)


# ------------------------------------------------------------- the ranks


def rank_mesh(shape, names):
    """A DeviceMesh of ``shape``; when it has fewer ranks than the world,
    one per block of ranks (a leading ``rep`` dimension, sliced off)."""
    from torch.distributed.device_mesh import DeviceMesh

    reps = WORLD // math.prod(shape)
    full = DeviceMesh("cpu", torch.arange(WORLD).reshape((reps,) + tuple(shape)),
                      mesh_dim_names=("rep",) + tuple(names))
    return full[tuple(names)]


def rank_train(out, case):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import from_numpy, to_numpy, tree_flatten, tree_unflatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.common import is_tuple
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import TrainConfig

    arch, shape, names, masked = TRAIN_CASES[case]
    cfg = get_smoke_config(arch)
    specs, treedef = tree_flatten(param_specs(cfg))
    leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                         (cfg.num_heads, cfg.head_dim))
    tcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=LR, warmup_steps=1))
    mesh = rank_mesh(shape, names)
    with use_mesh(mesh, rules_for("train", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh, tcfg)
    p_specs, o_specs, b_specs = cell.in_specs
    b_specs = {**b_specs, "loss_mask": b_specs["labels"]}
    full = tree_unflatten(treedef, [from_numpy(a) for a in leaves])
    params = SP.local_tree(full, p_specs, mesh)
    state = SP.local_tree(init_state(full), o_specs, mesh)
    losses, norms = [], []
    for batch in train_batches(cfg.vocab_size, masked):
        batch = SP.local_tree({k: from_numpy(v) for k, v in batch.items()},
                              {k: b_specs[k] for k in batch}, mesh)
        params, state, metrics = cell.fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out[f"{case}/coord"] = np.asarray(mesh.get_coordinate())
    out[f"{case}/loss"] = np.asarray(losses)
    out[f"{case}/grad_norm"] = np.asarray(norms)
    out[f"{case}/step"] = np.asarray(int(state.step))
    out[f"{case}/split"] = np.asarray([any(e is not None for e in s)
                                       for s in tree_flatten(p_specs, is_tuple)[0]])
    for name, tree in (("p", params), ("m", state.m), ("v", state.v)):
        for i, t in enumerate(tree_flatten(tree)[0]):
            out[f"{case}/{name}{i}"] = to_numpy(t)


def grad_case(name):
    """(cfg, rules override, builder) of one collective-gradient case; the
    builder maps (params, x) to the sublayer's output (its gradient taken
    against a fixed cotangent) or to the loss, under the active mesh."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import blocks
    from repro_torch.train.loss import chunked_cross_entropy

    base = get_smoke_config("llama3-8b").replace(d_model=16, head_dim=8, d_ff=24,
                                                 head_pad_multiple=1, vocab_pad_multiple=8)
    if name == "mlp":
        return base, {}, lambda p, x: blocks.mlp_apply(base, p, x)
    if name.startswith("attn"):
        if name == "attn_replicated_kv":       # 4 heads over 2 KV heads, wk / wv replicated
            cfg, rules = base.replace(num_heads=4, num_kv_heads=2, qkv_bias=True), {
                "kv_heads": None}
        else:                                  # 3 heads over 1: 12 columns a rank cut a head
            cfg, rules = base.replace(num_heads=3, num_kv_heads=1, qkv_bias=True), {}
        seg = cfg.decoder_plan()[0]

        def attn(p, x):
            pos = torch.arange(x.shape[1], dtype=torch.int32).expand(x.shape[0], -1)
            ctx = blocks.BlockCtx(mode="train", positions=pos)
            return blocks.attn_apply(cfg, seg, p, x, ctx)[0]
        return cfg, rules, attn
    cfg = base.replace(vocab_size=37)            # padded to 40: rank 1's last 3 columns

    def loss(p, x):
        labels = torch.from_numpy(np.random.default_rng(5).integers(0, 37, x.shape[:2]))
        mask = torch.from_numpy(np.random.default_rng(6).random(x.shape[:2]) < 0.7)
        return chunked_cross_entropy(cfg, p, x, labels, mask, chunk=4, z_loss_coeff=1e-2)[0]
    return cfg, {}, loss


def grad_params(cfg, name):
    """Whole fp32 params of a gradient case and their logical axes."""
    from repro_torch.interop import tree_flatten, tree_unflatten
    from repro_torch.models import blocks
    from repro_torch.models.common import is_tuple
    from repro_torch.models.transformer import param_specs

    if name == "mlp":
        specs = blocks.mlp_param_specs(cfg)
    elif name.startswith("attn"):
        specs = blocks.attn_param_specs(cfg)
    else:
        specs = {"lm_head": param_specs(cfg)["lm_head"]}
    leaves, treedef = tree_flatten(specs)
    rng = np.random.default_rng(4)
    arrays = [torch.from_numpy((0.3 * rng.standard_normal(s.shape)).astype(np.float32))
              for s in leaves]
    axes = tree_unflatten(treedef, [s.logical_axes for s in leaves])
    return tree_unflatten(treedef, arrays), axes, is_tuple


def rank_grads(out):
    """Each gradient case on a (1, 2) mesh: this rank's shards of the
    params, the whole input; the loss's gradients against autograd on the
    whole tensors in this process."""
    from repro_torch.distributed.sharding import logical_pspec, shard_slices, use_mesh
    from repro_torch.interop import tree_flatten, tree_map
    from repro_torch.launch.mesh import rules_for

    mesh = rank_mesh((1, 2), ("data", "model"))
    for name in GRAD_CASES:
        cfg, override, fn = grad_case(name)
        params, axes, is_tuple = grad_params(cfg, name)
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32))
        cot = torch.from_numpy(rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32))

        def backward(y):
            (y if y.dim() == 0 else (y * cot).sum()).backward()
            return y.detach()

        whole = tree_map(lambda t: t.clone().requires_grad_(True), params)
        xw = x.clone().requires_grad_(True)
        want = backward(fn(whole, xw))
        rules = {**rules_for("train", cfg), **override}
        with use_mesh(mesh, rules):
            specs = tree_map(lambda a, t: logical_pspec(a, t.shape, mesh), axes, params,
                             is_leaf=is_tuple)
            local = tree_map(lambda t, s: t[shard_slices(s, t.shape, mesh)].clone()
                             .requires_grad_(True), params, specs, is_leaf=is_tuple)
            xl = x.clone().requires_grad_(True)
            got = backward(fn(local, xl))
        errs = {"out": rel(got, want), "x": rel(xl.grad, xw.grad)}
        split = 0
        for i, (g, w, s) in enumerate(zip(tree_flatten(local)[0], tree_flatten(whole)[0],
                                          tree_flatten(specs, is_tuple)[0])):
            errs[f"p{i}"] = rel(g.grad, w.grad[shard_slices(s, w.shape, mesh)])
            split += any(e is not None for e in s)
        out[f"grad/{name}/errs"] = np.asarray(list(errs.values()))
        out[f"grad/{name}/split_leaves"] = np.asarray(split)


def rank_remat(out):
    """llama3-smoke's loss on (1, 2), its gradients taken on a thread where
    no mesh is active (as autograd's CUDA device thread runs a backward):
    with remat "full" the layers' recompute runs there, under the mesh
    captured at the forward; bitwise the gradients without remat."""
    import threading

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import from_numpy, tree_flatten, tree_unflatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.train_step import TrainConfig, loss_fn

    base = get_smoke_config("llama3-8b")
    specs, treedef = tree_flatten(param_specs(base))
    leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                         (base.num_heads, base.head_dim))
    mesh = rank_mesh((1, 2), ("data", "model"))
    rules = rules_for("train", base)
    with use_mesh(mesh, rules):
        p_specs = SP.param_pspecs(base, mesh)
    local = SP.local_tree(tree_unflatten(treedef, [from_numpy(a) for a in leaves]), p_specs, mesh)
    batch = {k: from_numpy(v) for k, v in train_batches(base.vocab_size, False)[0].items()}
    grads = {}
    for remat in ("none", "full"):
        cfg = base.replace(remat=remat)
        tracked = [t.detach().requires_grad_(True) for t in tree_flatten(local)[0]]
        with use_mesh(mesh, rules):
            loss, _ = loss_fn(cfg, TrainConfig(), tree_unflatten(treedef, tracked), batch)
        result = {}

        def backward():
            try:
                result["grads"] = torch.autograd.grad(loss, tracked)
            except Exception as e:      # noqa: BLE001 - re-raised on the caller's thread
                result["error"] = e

        thread = threading.Thread(target=backward)
        thread.start()
        thread.join()
        if "error" in result:
            raise result["error"]
        grads[remat] = result["grads"]
    out["remat/bitwise"] = np.asarray(all(torch.equal(a, b)
                                          for a, b in zip(grads["none"], grads["full"])))


def rank_main(rank, world, pg_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_path}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=DEADLINE_S))
    try:
        out = {}
        for case in TRAIN_CASES:
            rank_train(out, case)
        rank_grads(out)
        rank_remat(out)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the reference


def reference_main(path, cases):
    """The JAX package's jitted ``build_cell`` train step on each of
    ``cases`` (run as a script, 4 host devices): losses, and every device's
    shard of the params and moments after the steps."""
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
    for case in cases:
        arch, shape, names, masked = TRAIN_CASES[case]
        cfg = get_smoke_config(arch)
        specs, treedef = jax.tree_util.tree_flatten(
            param_specs(cfg), is_leaf=lambda v: isinstance(v, ParamSpec))
        leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                             (cfg.num_heads, cfg.head_dim))
        tcfg = rts.TrainConfig(optimizer=ropt.AdamWConfig(learning_rate=LR, warmup_steps=1))
        mesh = Mesh(devs[:math.prod(shape)].reshape(shape), names)
        with use_mesh(mesh, rules_for("train", cfg)):
            step, _ = RSP.build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh, tcfg)
            if masked:
                # build_cell's own step, its batch shardings with the mask's
                # beside the labels'
                sh = lambda tree: jax.tree.map(  # noqa: E731
                    lambda p: NamedSharding(mesh, p), tree,
                    is_leaf=lambda v: isinstance(v, PartitionSpec))
                b_specs = RSP.batch_pspecs(cfg, ShapeConfig("t", S, B, "train"), mesh)
                b_specs["loss_mask"] = b_specs["labels"]
                p_sh, o_sh = sh(RSP.param_pspecs(cfg, mesh)), sh(RSP.opt_pspecs(cfg, mesh))
                step = jax.jit(step.__wrapped__, in_shardings=(p_sh, o_sh, sh(b_specs)),
                               out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1))
            params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
            state = ropt.init_state(params)
            losses, norms = [], []
            for batch in train_batches(cfg.vocab_size, masked):
                params, state, metrics = step(params, state,
                                              {k: jnp.asarray(v) for k, v in batch.items()})
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        out[f"{case}/loss"] = np.asarray(losses)
        out[f"{case}/grad_norm"] = np.asarray(norms)
        pos = {dev.id: idx for idx, dev in np.ndenumerate(mesh.devices)}
        for name, tree in (("p", params), ("m", state.m), ("v", state.v)):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                out[f"{case}/{name}{i}"] = np.asarray(leaf)
                for shard in leaf.addressable_shards:
                    key = coord_key(pos[shard.device.id])
                    out[f"{case}/{name}{i}@{key}"] = np.asarray(shard.data)
    np.savez(path, **out)


# -------------------------------------------------------------- the run


def rel(a, b, scale=None) -> float:
    """||a - b|| over the norm of ``scale`` (default ``b``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = b if scale is None else np.asarray(scale, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(scale), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference subprocesses (one per architecture) and the 4
    ranks together; wait for all (within ``DEADLINE_S``); their results as
    dicts."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("tp_train")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4"
                          + " --xla_backend_optimization_level=0").strip())
    by_arch = {}
    for case, (arch, *_rest) in TRAIN_CASES.items():
        by_arch.setdefault(arch, []).append(case)
    refs = [subprocess.Popen([sys.executable, __file__, "reference", str(tmp / f"ref{i}.npz"),
                              *cases], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i, cases in enumerate(by_arch.values())]
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
    for i in range(len(by_arch)):
        ref.update(np.load(tmp / f"ref{i}.npz"))
    return ref, ranks


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_tp_train_cell_matches_reference(runs, case):
    ref, ranks = runs
    np.testing.assert_allclose(ranks[0][f"{case}/loss"], ref[f"{case}/loss"], rtol=TOL)
    np.testing.assert_allclose(ranks[0][f"{case}/grad_norm"], ref[f"{case}/grad_norm"],
                               rtol=TOL)
    n = len(ranks[0][f"{case}/split"])
    for r in ranks:
        assert int(r[f"{case}/step"]) == STEPS
        np.testing.assert_array_equal(r[f"{case}/loss"], ranks[0][f"{case}/loss"])
        key = coord_key(r[f"{case}/coord"])
        for name in ("p", "m", "v"):
            for i in range(n):
                got, want = r[f"{case}/{name}{i}"], ref[f"{case}/{name}{i}@{key}"]
                scale = ref[f"{case}/{name}{i}"]
                assert got.shape == want.shape, (name, i, got.shape, want.shape)
                if name == "v":         # in the gradients' units, as m
                    got, want, scale = np.sqrt(got), np.sqrt(want), np.sqrt(scale)
                err = rel(got, want, scale)
                assert err < TOL, (case, key, name, i, err)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_tp_train_replicated_leaves_bitwise_across_model_ranks(runs, case):
    """Ranks that differ only in their ``model`` coordinate hold the same
    bits of every replicated leaf and of its moments."""
    _, ranks = runs
    split = ranks[0][f"{case}/split"]
    assert split.any() and not split.all()
    groups = {}
    for r in ranks:
        groups.setdefault(coord_key(r[f"{case}/coord"][:-1]), []).append(r)
    peers = 0
    for group in groups.values():
        assert len({coord_key(r[f"{case}/coord"]) for r in group}) == \
            TRAIN_CASES[case][1][-1]
        for r in group[1:]:
            for name in ("p", "m", "v"):
                for i in np.flatnonzero(~split):
                    np.testing.assert_array_equal(r[f"{case}/{name}{i}"],
                                                  group[0][f"{case}/{name}{i}"])
            peers += 1
    assert peers > 0


@pytest.mark.parametrize("name", GRAD_CASES)
def test_collective_gradients_match_whole_autograd(runs, name):
    _, ranks = runs
    for r in ranks:
        assert int(r[f"grad/{name}/split_leaves"]) > 0
        errs = r[f"grad/{name}/errs"]
        assert (errs < GRAD_TOL).all(), errs


def test_remat_recompute_on_another_thread_is_bitwise(runs):
    _, ranks = runs
    assert all(bool(r["remat/bitwise"]) for r in ranks)


def test_ops_are_the_identity_without_a_mesh():
    """No mesh (and an abstract one): each op returns its input itself, so
    its gradient is the input's, and ``global_norm`` is the plain norm."""
    from repro_torch.distributed.sharding import MeshSpec, use_mesh
    from repro_torch.distributed.tensor_parallel import (Shard, all_gather, all_reduce_max,
                                                         all_reduce_sum, shard_of,
                                                         to_local_region)
    from repro_torch.train.optimizer import global_norm

    for ctx in (None, MeshSpec(("data", "model"), (1, 4))):
        with use_mesh(ctx):
            sh = shard_of("vocab", 40)
            assert not sh.split
            t = torch.arange(6.0).requires_grad_(True)
            out = to_local_region(all_gather(all_reduce_sum(t, sh), 0, sh), sh)
            assert out is t and all_reduce_max(t.detach(), sh) is not None
            (out * torch.arange(6.0)).sum().backward()
            assert torch.equal(t.grad, torch.arange(6.0))
            tree = {"a": torch.arange(4.0), "b": torch.ones(3)}
            assert torch.equal(global_norm(tree, [Shard(0, 4, 4), None]), global_norm(tree))


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2], sys.argv[3:])

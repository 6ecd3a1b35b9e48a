"""PyTorch port: distribution over 4 gloo ranks on the CPU, against the JAX
package.

One spawn of 4 ranks runs every case and writes what each rank holds; one
JAX subprocess (this file run as a script, with 4 host devices forced)
writes the reference's results; the two run at once, and the tests compare.
Meshes of 2 ranks are built twice over the 4 (a leading ``rep`` dimension,
sliced off), so every rank works in every case.

* The data-parallel ZeRO-1 train cell (``launch/specs.build_cell``), three
  steps of smollm-smoke with the global batch split over the batch's mesh
  axes: on (2, 1) ``(data, model)``, on (2, 2, 1) ``(pod, data, model)``
  (the moments nested over ``pod`` x ``data``), with a ``loss_mask`` whose
  shards hold unequal token counts (one none), and on (1, 2) and (2, 2)
  under ``parallelism="dp"`` (batch over ``data`` x ``model``).  Losses,
  params and each rank's ``m`` / ``v`` shard within 2e-5 (fp32, relative
  to the norm) of the JAX package's ``train_step`` on the whole batch.
* Shard-local MoE, TP and EP, on (1, 2) and (2, 2) at capacity factor 1.0
  (tokens dropped, asserted): outputs and aux within 1e-5 of the
  reference's ``_moe_forward_shard_local`` on the same mesh shape, with the
  experts passed as their shards and, under ``parallelism="dp"``, whole; one
  backward through EP on (2, 2) against dense autograd at capacity 8.0,
  the loss whole on every rank.
* ``reshard_tree``: each rank's local shard equal to the reference's
  device shard at its mesh coordinate.
* ``compressed_all_reduce`` over 2 ranks: the mean of the two ranks'
  dequantized values, bitwise, the error state each rank's own.
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

# train: smollm-smoke, global batch B x S, three steps
B, S, STEPS = 4, 16, 3
LR = 3e-3
MASK_LENGTHS = (16, 3, 9, 0)        # loss tokens per row: unequal shards, one empty
TRAIN_CASES = {                     # name: (mesh shape, names, parallelism, masked)
    "data2": ((2, 1), ("data", "model"), "tp", False),
    "pod2_data2": ((2, 2, 1), ("pod", "data", "model"), "tp", False),
    "pod2_data2_mask": ((2, 2, 1), ("pod", "data", "model"), "tp", True),
    "dp_1x2": ((1, 2), ("data", "model"), "dp", False),
    "dp_2x2": ((2, 2), ("data", "model"), "dp", False),
}
TRAIN_TOL = 2e-5

# MoE: d 16, ff 32, 4 experts, top-2, x [4, 8, 16]
MOE_D, MOE_FF, MOE_E, MOE_K = 16, 32, 4, 2
MOE_X = (4, 8, MOE_D)
MOE_MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MOE_TOL = 1e-5
RESHARD_MESH = ((2, 2), ("data", "model"))


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


def train_batches(vocab):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def loss_mask():
    return np.arange(S)[None, :] < np.asarray(MASK_LENGTHS)[:, None]


def moe_inputs(kind):
    rng = np.random.default_rng(7)
    p = {"router": rng.standard_normal((MOE_D, MOE_E)).astype(np.float32),
         "w_gate": (rng.standard_normal((MOE_E, MOE_D, MOE_FF)) / 4).astype(np.float32),
         "w_up": (rng.standard_normal((MOE_E, MOE_D, MOE_FF)) / 4).astype(np.float32),
         "w_down": (rng.standard_normal((MOE_E, MOE_FF, MOE_D)) / 6).astype(np.float32)}
    x = rng.standard_normal(MOE_X).astype(np.float32)
    return p, x


# ------------------------------------------------------------- the ranks


def rank_mesh(shape, names):
    """A DeviceMesh of ``shape``; when it has fewer ranks than the world,
    one per block of ranks (a leading ``rep`` dimension, sliced off)."""
    from torch.distributed.device_mesh import DeviceMesh

    reps = WORLD // math.prod(shape)
    full = DeviceMesh("cpu", torch.arange(WORLD).reshape((reps,) + tuple(shape)),
                      mesh_dim_names=("rep",) + tuple(names))
    return full[tuple(names)]


def slices_array(sl):
    return np.asarray([[s.start, s.stop] for s in sl], np.int64)


def rank_train(out):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import shard_slices, use_mesh
    from repro_torch.interop import from_numpy, to_numpy, tree_flatten, tree_unflatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.common import is_tuple
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import TrainConfig

    base = get_smoke_config("smollm-135m")
    specs, treedef = tree_flatten(param_specs(base))
    leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                         (base.num_heads, base.head_dim))
    tcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=LR, warmup_steps=1))
    for case, (shape, names, par, masked) in TRAIN_CASES.items():
        cfg = base.replace(parallelism=par)
        mesh = rank_mesh(shape, names)
        with use_mesh(mesh, rules_for("train", cfg)):
            cell = SP.build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh, tcfg)
        p_specs, o_specs, b_specs = cell.in_specs
        b_specs = {**b_specs, "loss_mask": b_specs["labels"]}
        params = tree_unflatten(treedef, [from_numpy(a) for a in leaves])
        state = SP.local_tree(init_state(params), o_specs, mesh)
        losses = []
        for batch in train_batches(cfg.vocab_size):
            if masked:
                batch = {**batch, "loss_mask": loss_mask()}
            batch = SP.local_tree({k: from_numpy(v) for k, v in batch.items()},
                                  {k: b_specs[k] for k in batch}, mesh)
            params, state, metrics = cell.fn(params, state, batch)
            losses.append(float(metrics["loss"]))
        out[f"{case}/loss"] = np.asarray(losses)
        out[f"{case}/step"] = np.asarray(int(state.step))
        for i, p in enumerate(tree_flatten(params)[0]):
            out[f"{case}/p{i}"] = to_numpy(p)
        zspecs = tree_flatten(o_specs.m, is_tuple)[0]
        for name, tree in (("m", state.m), ("v", state.v)):
            for i, (t, spec, full) in enumerate(zip(tree_flatten(tree)[0], zspecs, leaves)):
                out[f"{case}/{name}{i}"] = to_numpy(t)
                out[f"{case}/{name}{i}_sl"] = slices_array(shard_slices(spec, full.shape, mesh))


def rank_moe(out):
    import types

    import torch.distributed as dist

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.moe import _moe_forward_dense, moe_forward

    for mname, shape in MOE_MESHES.items():
        mesh = rank_mesh(shape, ("data", "model"))
        d, m = mesh.get_coordinate()
        n_data, n_model = shape
        for kind in ("tp", "ep"):
            p, x = moe_inputs(kind)
            bl = MOE_X[0] // n_data
            x_l = torch.from_numpy(x[d * bl:(d + 1) * bl])
            if kind == "tp":
                fl = MOE_FF // n_model
                p_l = {"router": p["router"], "w_gate": p["w_gate"][:, :, m * fl:(m + 1) * fl],
                       "w_up": p["w_up"][:, :, m * fl:(m + 1) * fl],
                       "w_down": p["w_down"][:, m * fl:(m + 1) * fl]}
            else:
                el = MOE_E // n_model
                p_l = {k: (v if k == "router" else v[m * el:(m + 1) * el]) for k, v in p.items()}
            p_l = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p_l.items()}
            with use_mesh(mesh):
                y, aux = moe_forward(p_l, x_l, MOE_K, 1.0, shard_local=True, moe_sharding=kind)
            # parallelism="dp": the rules replicate the experts, so every
            # rank passes them whole and takes its shard itself
            with use_mesh(mesh, rules_for("train", types.SimpleNamespace(parallelism="dp"))):
                y_dp, aux_dp = moe_forward({k: torch.from_numpy(v) for k, v in p.items()}, x_l,
                                           MOE_K, 1.0, shard_local=True, moe_sharding=kind)
            for key, y, aux in ((f"moe/{mname}/{kind}", y, aux),
                                (f"moe/{mname}/{kind}_dp", y_dp, aux_dp)):
                out[f"{key}/y"] = y.numpy()
                out[f"{key}/coord"] = np.asarray([d, m])
                for k, v in aux.items():
                    out[f"{key}/{k}"] = np.asarray(float(v))

    # one backward through EP on (2, 2) against dense autograd at capacity 8.0,
    # each rank's loss whole (y . cot over its data shard's tokens): the
    # gradients of x and the router, replicated over model, whole on every
    # model rank, summed over data where the ranks hold distinct tokens
    mesh = rank_mesh((2, 2), ("data", "model"))
    d, m = mesh.get_coordinate()
    p, x = moe_inputs("ep")
    cot = np.random.default_rng(11).standard_normal(MOE_X).astype(np.float32)
    pf = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xf = torch.from_numpy(x).requires_grad_(True)
    y, _ = _moe_forward_dense(pf, xf, MOE_K, 8.0)
    (y * torch.from_numpy(cot)).sum().backward()
    bl, el = MOE_X[0] // 2, MOE_E // 2
    pl = {k: torch.from_numpy(np.ascontiguousarray(v if k == "router" else v[m * el:(m + 1) * el]))
          .requires_grad_(True) for k, v in p.items()}
    xl = torch.from_numpy(x[d * bl:(d + 1) * bl].copy()).requires_grad_(True)
    with use_mesh(mesh):
        yl, _ = moe_forward(pl, xl, MOE_K, 8.0, shard_local=True, moe_sharding="ep")
    (yl * torch.from_numpy(cot[d * bl:(d + 1) * bl])).sum().backward()
    gx, grouter = xl.grad.clone(), pl["router"].grad.clone()
    dist.all_reduce(grouter, group=mesh.get_group("data"))
    errs = [(yl.detach() - y.detach()[d * bl:(d + 1) * bl]).abs().max(),
            (gx - xf.grad[d * bl:(d + 1) * bl]).abs().max(),
            (grouter - pf["router"].grad).abs().max()]
    for k in ("w_gate", "w_up", "w_down"):
        g = pl[k].grad.clone()
        dist.all_reduce(g, group=mesh.get_group("data"))
        errs.append((g - pf[k].grad[m * el:(m + 1) * el]).abs().max())
    out["moe_ep_backward/max_err"] = np.asarray([float(e) for e in errs])


def rank_reshard(out):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.interop import to_numpy, tree_flatten, tree_unflatten
    from repro_torch.models.transformer import param_specs

    cfg = get_smoke_config("smollm-135m")
    specs, treedef = tree_flatten(param_specs(cfg))
    leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                         (cfg.num_heads, cfg.head_dim))
    mesh = rank_mesh(*RESHARD_MESH)
    placed = reshard_tree(cfg, mesh, tree_unflatten(treedef, leaves))
    out["reshard/coord"] = np.asarray(mesh.get_coordinate())
    for i, t in enumerate(tree_flatten(placed)[0]):
        out[f"reshard/p{i}"] = to_numpy(t.to_local())
        out[f"reshard/placements{i}"] = np.asarray(str(t.placements))


def rank_compressed(out):
    from repro_torch.distributed.collectives import compressed_all_reduce, quantize_int8

    mesh = rank_mesh((2, 2), ("data", "model"))
    rng = np.random.default_rng(100 + torch.distributed.get_rank())
    x = torch.from_numpy(rng.standard_normal((33, 17)).astype(np.float32))
    err = torch.from_numpy(0.01 * rng.standard_normal((33, 17)).astype(np.float32))
    mean, new_err = compressed_all_reduce(x, mesh.get_group("data"), err)
    q, scale, own_err = quantize_int8(x, err)
    out["compressed/coord"] = np.asarray(mesh.get_coordinate())
    out["compressed/deq"] = (q.float() * scale).numpy()
    out["compressed/mean"] = mean.numpy()
    out["compressed/new_err"] = new_err.numpy()
    out["compressed/own_err"] = own_err.numpy()


def rank_main(rank, world, pg_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_path}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=DEADLINE_S))
    try:
        out = {}
        for part in (rank_train, rank_moe, rank_reshard, rank_compressed):
            part(out)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the reference


def reference_main(path):
    """The JAX package's results for every case (run as a script, 4 host
    devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    import repro.launch.specs as RSP
    import repro.train.optimizer as ropt
    import repro.train.train_step as rts
    from repro.configs.registry import get_smoke_config
    from repro.distributed.sharding import use_mesh
    from repro.models.common import ParamSpec
    from repro.models.moe import _moe_forward_shard_local
    from repro.models.transformer import param_specs

    out = {}
    cfg = get_smoke_config("smollm-135m")
    specs, treedef = jax.tree_util.tree_flatten(param_specs(cfg),
                                                is_leaf=lambda v: isinstance(v, ParamSpec))
    leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                         (cfg.num_heads, cfg.head_dim))
    tcfg = rts.TrainConfig(optimizer=ropt.AdamWConfig(learning_rate=LR, warmup_steps=1))
    step = jax.jit(lambda p, s, b: rts.train_step(cfg, tcfg, p, s, b))
    for masked in (False, True):
        params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
        state = ropt.init_state(params)
        losses = []
        for batch in train_batches(cfg.vocab_size):
            if masked:
                batch = {**batch, "loss_mask": loss_mask()}
            params, state, metrics = step(params, state, {k: jnp.asarray(v)
                                                          for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
        key = "train_mask" if masked else "train"
        out[f"{key}/loss"] = np.asarray(losses)
        for name, tree in (("p", params), ("m", state.m), ("v", state.v)):
            for i, a in enumerate(jax.tree_util.tree_leaves(tree)):
                out[f"{key}/{name}{i}"] = np.asarray(a)

    devs = np.array(jax.devices()[:WORLD])
    for mname, shape in MOE_MESHES.items():
        mesh = Mesh(devs[:math.prod(shape)].reshape(shape), ("data", "model"))
        for kind in ("tp", "ep"):
            p, x = moe_inputs(kind)
            fn = jax.jit(lambda p_, x_: _moe_forward_shard_local(p_, x_, MOE_K, 1.0, kind, mesh))
            with use_mesh(mesh):
                y, aux = fn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
            out[f"moe/{mname}/{kind}/y"] = np.asarray(y)
            for k, v in aux.items():
                out[f"moe/{mname}/{kind}/{k}"] = np.asarray(float(v))

    mesh = Mesh(devs.reshape(RESHARD_MESH[0]), RESHARD_MESH[1])
    with use_mesh(mesh):
        pspecs = jax.tree_util.tree_leaves(RSP.param_pspecs(cfg, mesh),
                                           is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec))
    pos = {dev.id: idx for idx, dev in np.ndenumerate(mesh.devices)}
    for i, (a, spec) in enumerate(zip(leaves, pspecs)):
        placed = jax.device_put(a, NamedSharding(mesh, spec))
        for shard in placed.addressable_shards:
            dm = pos[shard.device.id]
            out[f"reshard/p{i}@{dm[0]}{dm[1]}"] = np.asarray(shard.data)
    np.savez(path, **out)


# -------------------------------------------------------------- the run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference subprocess and the 4 ranks together; wait for
    both (within ``DEADLINE_S``); their results as dicts."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4").strip())
    ref = subprocess.Popen([sys.executable, __file__, "reference", str(tmp / "ref.npz")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
        log, _ = ref.communicate(timeout=max(1.0, DEADLINE_S - (time.monotonic() - t0)))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(np.load(tmp / "ref.npz")), ranks


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_dp_zero1_train_matches_reference(runs, case):
    ref, ranks = runs
    key = "train_mask" if TRAIN_CASES[case][3] else "train"
    n_params = sum(1 for k in ref if k.startswith(f"{key}/p"))
    shards = 0
    for r in ranks:
        assert int(r[f"{case}/step"]) == STEPS
        np.testing.assert_allclose(r[f"{case}/loss"], ref[f"{key}/loss"], rtol=TRAIN_TOL)
        for i in range(n_params):
            assert rel(r[f"{case}/p{i}"], ref[f"{key}/p{i}"]) < TRAIN_TOL, (case, i)
            for name in ("m", "v"):
                sl = tuple(slice(a, b) for a, b in r[f"{case}/{name}{i}_sl"])
                want = ref[f"{key}/{name}{i}"][sl]
                got = r[f"{case}/{name}{i}"]
                assert got.shape == want.shape
                shards += got.size < ref[f"{key}/{name}{i}"].size
                assert rel(got, want) < TRAIN_TOL, (case, name, i)
    data_ranks = math.prod(s for s, n in zip(*TRAIN_CASES[case][:2]) if n in ("pod", "data"))
    assert (shards > 0) == (data_ranks > 1), "ZeRO-1 moments not sharded as the specs say"


@pytest.mark.parametrize("mesh_name,kind", [(m, k) for m in MOE_MESHES
                                             for k in ("tp", "ep", "tp_dp", "ep_dp")])
def test_moe_shard_local_matches_reference(runs, mesh_name, kind):
    """The "_dp" kinds pass the experts whole under ``parallelism="dp"``'s
    rules; the reference's ``shard_map`` splits them over ``model`` whatever
    the rules, so its one call is held against both."""
    ref, ranks = runs
    key = f"moe/{mesh_name}/{kind}"
    want = f"moe/{mesh_name}/{kind.removesuffix('_dp')}"
    n_data = MOE_MESHES[mesh_name][0]
    bl = MOE_X[0] // n_data
    assert float(ref[f"{want}/moe_drop_frac"]) > 0, "the case must drop tokens"
    for r in ranks:
        d, _ = r[f"{key}/coord"]
        np.testing.assert_allclose(r[f"{key}/y"], ref[f"{want}/y"][d * bl:(d + 1) * bl],
                                   atol=MOE_TOL, rtol=MOE_TOL)
        for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac"):
            np.testing.assert_allclose(r[f"{key}/{k}"], ref[f"{want}/{k}"],
                                       atol=MOE_TOL, rtol=MOE_TOL)


def test_moe_ep_backward_matches_dense(runs):
    _, ranks = runs
    for r in ranks:
        errs = r["moe_ep_backward/max_err"]   # y, x, router, w_gate, w_up, w_down
        assert (errs < MOE_TOL).all(), errs


def test_reshard_local_shards_match_reference(runs):
    ref, ranks = runs
    n = sum(1 for k in ranks[0] if k.startswith("reshard/placements"))
    sharded = 0
    for r in ranks:
        d, m = r["reshard/coord"]
        for i in range(n):
            want = ref[f"reshard/p{i}@{d}{m}"]
            np.testing.assert_array_equal(r[f"reshard/p{i}"], want)
            sharded += "Shard" in str(r[f"reshard/placements{i}"])
    assert sharded > 0


def test_compressed_all_reduce_over_two_ranks(runs):
    _, ranks = runs
    by_model = {}
    for r in ranks:
        by_model.setdefault(int(r["compressed/coord"][1]), []).append(r)
    for group in by_model.values():
        group.sort(key=lambda r: int(r["compressed/coord"][0]))
        want = (group[0]["compressed/deq"] + group[1]["compressed/deq"]) / np.float32(2)
        for r in group:
            np.testing.assert_array_equal(r["compressed/mean"], want)
            np.testing.assert_array_equal(r["compressed/new_err"], r["compressed/own_err"])
        assert not np.array_equal(group[0]["compressed/new_err"], group[1]["compressed/new_err"])


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])

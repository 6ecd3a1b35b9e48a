"""PyTorch port: distribution and launch against the JAX package, on the
CPU, in one process (no ranks but a 1-rank gloo group).

* For every ``runnable_cells`` cell on both production meshes, under
  ``rules_for(kind, cfg)``: the port's param, ZeRO-1 ``m`` / ``v``, batch
  and cache specs exactly the reference's (the reference on an
  ``AbstractMesh``, its rules set on its thread-local context), and the
  dry run's per-device argument bytes and parameter count the ones reckoned
  from the reference's specs and abstract shapes.
* ``plan_remesh`` reports equal for the ten architectures on both meshes
  and on ``(1,)`` ``"model"``.
* A multi-axis spec entry nests major-first: the ``(2, 2)`` ``("data",
  "model")`` mesh under ``parallelism="dp"`` puts batch on both axes, as
  ``Shard(0)`` twice in mesh order; a tuple out of mesh order is refused.
* The int8 functions bitwise the reference's; the reference's two int8
  tests repeated on the port.
* On a 1-rank gloo ``DeviceMesh``: the reference's elastic-restore tests
  (one batched store read, trees bitwise equal) and its shard-local MoE
  test (TP and EP equal to dense at capacity factor 8.0).
* A ZeRO-1 update with a fixed gradient tree over 2 simulated shards is
  bitwise ``apply_update``.

Multi-rank parity is ``tests/test_torch_distributed_ranks.py``.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import repro.distributed.collectives as rcoll
import repro.distributed.elastic as relastic
import repro.distributed.sharding as RS
import repro.launch.specs as RSP
import repro.models.transformer as RM
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import runnable_cells as ref_runnable_cells
from repro.configs.registry import skipped_cells as ref_skipped_cells
from repro.launch.mesh import rules_for as ref_rules_for
from repro.models.common import count_params as ref_count_params
from repro.models.common import tree_bytes as ref_tree_bytes
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import (ARCH_IDS, get_config, get_shape, get_smoke_config,
                                         runnable_cells, skipped_cells)
from repro_torch.core import HostArrayStore
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as S
from repro_torch.distributed.elastic import (plan_remesh, reshard_tree,
                                             restore_train_state_elastic)
from repro_torch.interop import from_numpy, to_numpy, tree_flatten, tree_map
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import init_process_group, make_production_mesh, rules_for
from repro_torch.models import transformer as T
from repro_torch.models.common import (count_params, init_param_tree, is_tuple, shapes_tree,
                                      tree_bytes)
from repro_torch.models.moe import _moe_forward_dense, moe_forward, moe_param_specs
from repro_torch.train import optimizer as opt
from repro_torch.train import paged_state as ps
from repro_torch.train.ooc import OOCTrainer, OOCTrainerConfig
from repro_torch.train.train_step import TrainConfig

MESHES = {False: "pod16x16", True: "pod2x16x16"}


def ref_mesh(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def ref_rules(rules):
    """The reference's rules for this thread (its ``use_mesh`` refuses an
    ``AbstractMesh``, and its spec functions take the mesh explicitly)."""
    prev = RS._CTX.rules
    RS._CTX.rules = dict(rules)
    try:
        yield
    finally:
        RS._CTX.rules = prev


def ref_specs(tree) -> list:
    return [tuple(p) for p in jax.tree_util.tree_leaves(tree, is_leaf=lambda v: isinstance(v, P))]


def port_specs(tree) -> list:
    return tree_flatten(tree, is_tuple)[0]


def ref_cache_named(tree) -> list:
    """The reference's cache specs per segment by name: its mLSTM / sLSTM
    ``state`` tuple as the port's flat entries."""
    out = []
    for seg in tree:
        named = {}
        for k, v in seg.items():
            if k == "state":
                names = ("C", "n", "m") if len(v) == 3 else ("c", "n", "m", "h")
                named.update(zip(names, (tuple(x) for x in v)))
            else:
                named[k] = tuple(v)
        out.append(named)
    return out


def ref_bytes(abstract, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(abstract)
    spec_leaves = ref_specs(specs)
    assert len(leaves) == len(spec_leaves)
    total = 0
    for a, spec in zip(leaves, spec_leaves):
        parts = math.prod(mesh.shape[ax] for e in spec for ax in S.entry_axes(e))
        total += math.prod(a.shape) * a.dtype.itemsize // parts
    return total


def ref_argument_bytes(cfg, shape, mesh) -> int:
    """Per-device bytes of the reference cell's arguments, from its specs
    and abstract shapes (``build_cell``'s argument tuple)."""
    total = ref_bytes(RSP.abstract_params(cfg), RSP.param_pspecs(cfg, mesh), mesh)
    batch, b_specs = RSP.input_specs(cfg, shape), RSP.batch_pspecs(cfg, shape, mesh)
    if shape.kind == "train":
        total += ref_bytes(RSP.abstract_opt_state(cfg), RSP.opt_pspecs(cfg, mesh), mesh)
    if shape.kind == "decode":
        total += ref_bytes(RSP.abstract_cache(cfg, shape), RSP.cache_pspecs(cfg, shape, mesh),
                           mesh)
    return total + ref_bytes(batch, b_specs, mesh)


def test_runnable_cells_are_the_references():
    assert sorted(runnable_cells()) == sorted(ref_runnable_cells())
    assert len(runnable_cells()) == 33
    assert sorted(skipped_cells()) == sorted(ref_skipped_cells())
    assert all(get_shape(n) == SHAPES[n] and REF_SHAPES[n].tokens == SHAPES[n].tokens
               for n in SHAPES)


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b", "xlstm-1.3b"])
def test_tree_views_equal_reference(arch):
    """``param_logical_axes`` / ``shapes_tree`` leaf by leaf, and the
    counts of the abstract params, as the reference's; the sharding tree's
    placements those of the specs."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    is_axes = lambda v: isinstance(v, tuple) and all(a is None or isinstance(a, str)  # noqa: E731
                                                     for a in v)
    assert port_specs(T.param_logical_axes(cfg)) == jax.tree_util.tree_leaves(
        RM.param_logical_axes(rcfg), is_leaf=is_axes)
    shapes = shapes_tree(T.param_specs(cfg))
    assert port_specs(shapes) == [tuple(a.shape) for a in
                                  jax.tree_util.tree_leaves(RSP.abstract_params(rcfg))]
    a_params = SP.abstract_params(cfg)
    assert count_params(a_params) == ref_count_params(RSP.abstract_params(rcfg))
    assert tree_bytes(a_params) == ref_tree_bytes(RSP.abstract_params(rcfg))
    mesh = make_production_mesh()
    with S.use_mesh(mesh):
        tree = S.param_sharding_tree(T.param_logical_axes(cfg), shapes)
        want = [S.placements(s, mesh) for s in port_specs(SP.param_pspecs(cfg, mesh))]
    got = tree_flatten(tree)[0]
    assert all(isinstance(g, S.Sharding) and g.mesh == mesh for g in got)
    assert [g.placements for g in got] == want


@pytest.mark.parametrize("arch,shape_name", sorted(runnable_cells()))
def test_cell_specs_equal_reference(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shape, rshape = SHAPES[shape_name], REF_SHAPES[shape_name]
    for multi_pod in (False, True):
        mesh, rmesh = make_production_mesh(multi_pod=multi_pod), ref_mesh(multi_pod)
        where = f"{arch} {shape_name} {MESHES[multi_pod]}"
        with S.use_mesh(mesh, rules_for(shape.kind, cfg)), \
                ref_rules(ref_rules_for(rshape.kind, rcfg)):
            assert port_specs(SP.param_pspecs(cfg, mesh)) == \
                ref_specs(RSP.param_pspecs(rcfg, rmesh)), where
            assert port_specs(SP.opt_pspecs(cfg, mesh)) == \
                ref_specs(RSP.opt_pspecs(rcfg, rmesh)), where
            assert SP.batch_pspecs(cfg, shape, mesh) == \
                {k: tuple(v) for k, v in RSP.batch_pspecs(rcfg, rshape, rmesh).items()}, where
            if shape.kind != "train":
                assert SP.cache_pspecs(cfg, shape, mesh) == \
                    ref_cache_named(RSP.cache_pspecs(rcfg, rshape, rmesh)), where
                shapes = [{k: tuple(t.shape) for k, t in seg.items()}
                          for seg in SP.abstract_cache(cfg, shape)]
                rshapes = ref_cache_named(jax.tree_util.tree_map(
                    lambda a: a.shape, RSP.abstract_cache(rcfg, rshape)))
                assert shapes == rshapes, where


@pytest.mark.parametrize("arch,shape_name", sorted(runnable_cells()))
def test_dryrun_bytes_equal_reference(arch, shape_name, tmp_path, capsys):
    rcfg, rshape = ref_get_config(arch), REF_SHAPES[shape_name]
    for multi_pod in (False, True):
        rec = run_cell(arch, shape_name, multi_pod, tmp_path, execute=False)
        assert rec["ok"], rec.get("traceback")
        rmesh = ref_mesh(multi_pod)
        with ref_rules(ref_rules_for(rshape.kind, rcfg)):
            want = ref_argument_bytes(rcfg, rshape, rmesh)
        assert rec["memory"]["argument_bytes"] == want, (arch, shape_name, multi_pod)
        assert rec["params"] == ref_count_params(RSP.abstract_params(rcfg))
        assert rec["devices"] == rmesh.size
        assert (tmp_path / f"{arch}__{shape_name}__{MESHES[multi_pod]}.json").is_file()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_remesh_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                         ((1,), ("model",))):
        got = plan_remesh(cfg, S.MeshSpec(names, shape))
        want = relastic.plan_remesh(rcfg, AbstractMesh(shape, names))
        assert (got.ok, got.devices, got.replicated_leaves, got.sharded_leaves, got.notes) == \
            (want.ok, want.devices, want.replicated_leaves, want.sharded_leaves, want.notes)


def test_multi_axis_entries_nest_major_first_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_smoke_config("smollm-135m").replace(parallelism="dp")
    rcfg = ref_get_config("smollm-135m").replace(parallelism="dp")
    mesh = S.MeshSpec(("data", "model"), (2, 2))
    with S.use_mesh(mesh, rules_for("train", cfg)), ref_rules(ref_rules_for("train", rcfg)):
        spec = S.logical_pspec(("batch", "seq"), (8, 16))
        assert spec == tuple(RS.logical_pspec(("batch", "seq"), (8, 16),
                                              AbstractMesh((2, 2), ("data", "model"))))
    assert spec == (("data", "model"), None)
    assert S.placements(spec, mesh) == [Shard(0), Shard(0)]
    # data-major: the shard at (data d, model m) is rows 2d + m of four
    for d in range(2):
        for m in range(2):
            sl = S.shard_slices(spec, (8, 16), mesh, (d, m))[0]
            assert (sl.start, sl.stop) == (2 * (2 * d + m), 2 * (2 * d + m) + 2)
    with pytest.raises(ValueError, match="mesh order"):
        S.placements((("model", "data"), None), mesh)
    assert S.placements((None, "model"), mesh) == [Replicate(), Shard(1)]


def test_with_logical_constraint_is_a_no_op_on_plain_tensors():
    x = torch.ones(4, 8)
    assert S.with_logical_constraint(x, "batch", "embed") is x
    with S.use_mesh(make_production_mesh()):
        assert S.with_logical_constraint(x, "batch", "embed") is x


# ------------------------------------------------------------------ int8


def test_int8_functions_bitwise_equal_reference():
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=(64, 48)).astype(np.float32),
         "b": [rng.normal(size=(7,)).astype(np.float32) * 1e-3,
               rng.normal(size=(3, 5, 2)).astype(np.float32) * 40.0]}
    err = {"a": rng.normal(size=(64, 48)).astype(np.float32) * 1e-2,
           "b": [np.zeros(7, np.float32), rng.normal(size=(3, 5, 2)).astype(np.float32)]}
    tg, terr = tree_map(from_numpy, g), tree_map(from_numpy, err)
    for x, e in zip(tree_flatten(tg)[0], tree_flatten(terr)[0]):
        got = coll.quantize_int8(x, e)
        want = rcoll.quantize_int8(jnp.asarray(x.numpy()), jnp.asarray(e.numpy()))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got[0].dtype == torch.int8
    got = coll.compress_grads(tg, terr)
    want = rcoll.compress_grads(jax.tree_util.tree_map(jnp.asarray, g),
                                jax.tree_util.tree_map(jnp.asarray, err))
    for gt, wt in zip(got, want):
        for a, b in zip(tree_flatten(gt)[0], jax.tree_util.tree_leaves(wt)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    deq = coll.decompress_grads(got[0], got[1])
    rdeq = rcoll.decompress_grads(want[0], want[1])
    for a, b in zip(tree_flatten(deq)[0], jax.tree_util.tree_leaves(rdeq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_compression_error_feedback_converges():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    err = coll.init_error_state(g)
    acc = torch.zeros_like(g["w"])
    n = 50
    for _ in range(n):
        q, s, err = coll.compress_grads(g, err)
        acc = acc + coll.decompress_grads(q, s)["w"]
    rel = float((acc / n - g["w"]).abs().max() / g["w"].abs().max())
    assert rel < 2e-3, f"error feedback did not debias: rel={rel}"


def test_int8_compression_is_4x_smaller():
    g = {"w": torch.ones(128, 128)}
    q, s, _ = coll.compress_grads(g, coll.init_error_state(g))
    assert q["w"].dtype == torch.int8
    assert q["w"].numel() * q["w"].element_size() * 4 == g["w"].numel() * g["w"].element_size()


# --------------------------------------------------- 1-rank process group


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A 1-rank gloo group (a file store: no TCP port); destroyed at the
    end, so the next file in this worker starts clean."""
    path = tmp_path_factory.mktemp("pg") / "store"
    init_process_group("cpu", f"file://{path}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def to_host(leaf):
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return to_numpy(leaf.to_local())
    return np.asarray(leaf)


def test_host_mesh_is_the_groups_world(one_rank):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh("cpu")
    assert mesh.mesh_dim_names == ("data",) and tuple(mesh.shape) == (1,)
    with pytest.raises(RuntimeError, match="nccl"):
        make_host_mesh("cuda")


def test_elastic_restore_across_meshes(one_rank, tmp_path):
    """Save from one layout, restore + re-place on a different mesh."""
    cfg = get_smoke_config("smollm-135m")
    params = T.init_params(cfg, seed=0, device="cpu")
    ckpt.save(tmp_path, 1, params)
    arrays = ckpt.restore(tmp_path, 1, params)
    mesh = device_mesh((1,), ("model",))
    report = plan_remesh(cfg, mesh)
    assert report.devices == 1
    placed = reshard_tree(cfg, mesh, arrays)
    for a, b in zip(tree_flatten(params)[0], tree_flatten(placed)[0]):
        np.testing.assert_array_equal(to_numpy(a), to_host(b))


TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
PAGE = 4096


def test_restore_onto_different_mesh_batched(one_rank):
    """A paged ``OOCTrainer`` checkpoint restored through ONE batched store
    read, re-placed on a different mesh: trees bitwise equal, and the
    restored tree loads back into a fresh paged trainer exactly."""
    cfg = ModelConfig(**TINY)
    params = tree_map(to_numpy, T.init_params(cfg, seed=1, device="cpu"))
    _, specs, _ = ps.pack_tree(params, PAGE)
    mv = tree_map(lambda p: np.zeros(2 * p.size, np.float32), params)
    _, mv_specs, _ = ps.pack_tree(mv, PAGE)
    pt, mt = sum(s["npages"] for s in specs), sum(s["npages"] for s in mv_specs)
    p_slots = max(2 * max(s["npages"] for s in specs), pt // 2)
    ocfg = OOCTrainerConfig(page_size=PAGE, params_buffer_pages=p_slots,
                            moments_buffer_pages=max(8, (pt + mt) // 2 - p_slots))

    def make():
        return OOCTrainer(cfg, TrainConfig(), ocfg, paged=True, params=params, device="cpu")

    rng = np.random.default_rng(0)
    tr = make()
    try:
        for _ in range(2):
            tr.step({"tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
                     "labels": rng.integers(0, 256, (2, 16)).astype(np.int32)})
        state = tr.state_dict()
    finally:
        tr.close()

    nbytes = sum(np.asarray(a).nbytes for a in tree_flatten(state)[0])
    store = HostArrayStore(np.zeros(nbytes + PAGE, np.uint8))
    manifest = ckpt.save_tree_to_store(store, state)
    store.reset_stats()
    mesh = device_mesh((1,), ("model",))
    like = tree_map(lambda a: np.zeros_like(np.asarray(a)), state)
    restored, report = restore_train_state_elastic(cfg, mesh, store, manifest, like)
    assert report.devices == 1
    assert store.num_reads == 1, "restore must be ONE batched read"
    assert int(np.asarray(restored["step"]).reshape(-1)[0]) == int(state["step"])
    host = tree_map(to_host, {k: v for k, v in restored.items() if k != "step"})
    for a, b in zip(tree_flatten(host)[0],
                    tree_flatten({k: v for k, v in state.items() if k != "step"})[0]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))

    tr2 = make()
    try:
        tr2.load_state_dict({**host, "step": restored["step"]})
        assert tr2.step_no == int(state["step"])
        for a, b in zip(tree_flatten(tr2.state_dict())[0], tree_flatten(state)[0]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    finally:
        tr2.close()


def test_moe_shard_local_matches_dense(one_rank):
    """Mesh-local dispatch (TP and EP) == dense dispatch on a 1x1 mesh,
    through ``moe_forward`` with the mesh active."""
    d, ff, E, K = 16, 32, 4, 2
    x = torch.randn(2, 8, d, generator=torch.Generator().manual_seed(1))
    mesh = device_mesh((1, 1), ("data", "model"))
    for kind in ("tp", "ep"):
        p = init_param_tree(moe_param_specs(d, ff, E, kind), torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
        y_ref, aux_ref = _moe_forward_dense(p, x, K, 8.0)
        with S.use_mesh(mesh):
            y, aux = moe_forward(p, x, K, 8.0, shard_local=True, moe_sharding=kind)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5, rtol=1e-5)
        for k in aux_ref:
            np.testing.assert_allclose(float(aux[k]), float(aux_ref[k]), rtol=1e-5)


# ----------------------------------------------------------------- ZeRO-1


def test_zero1_update_over_two_shards_is_bitwise_apply_update():
    zero1_update_over_two_shards(in_place=False)


def test_zero1_update_in_place_is_bitwise_apply_update(monkeypatch):
    """Written into the param slices and moments in blocks of a few rows (a
    small IN_PLACE_CHUNK makes every leaf several blocks): the same bits."""
    monkeypatch.setattr(SP, "IN_PLACE_CHUNK", 64)
    zero1_update_over_two_shards(in_place=True)


def zero1_update_over_two_shards(in_place):
    """Each ZeRO-1 shard's update (``zero1_local_update``, ``in_place`` or
    as new tensors) bitwise ``apply_update``'s."""
    cfg = get_smoke_config("smollm-135m")
    ocfg = opt.AdamWConfig(warmup_steps=2)
    params = T.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 0.1, params)
    # a state with nonzero moments: one update first
    params, state, _ = opt.apply_update(ocfg, params, grads, opt.init_state(params))
    want_p, want_s, _ = opt.apply_update(ocfg, params, grads, state)

    mesh = S.MeshSpec(("data", "model"), (2, 1))
    o_specs = SP.opt_pspecs(cfg, mesh)
    assert any(e == "data" for s in port_specs(o_specs.m) for e in s)
    scalars = opt.update_scalars(ocfg, state.step, opt.global_norm(grads))
    given = tree_map(torch.clone, params)
    got_p = tree_map(torch.empty_like, params)
    got_m, got_v = tree_map(torch.empty_like, state.m), tree_map(torch.empty_like, state.v)
    for coord in ((0, 0), (1, 0)):
        local = SP.local_tree(state, o_specs, mesh, coord)
        p_l, s_l = SP.zero1_local_update(ocfg, given, grads, local, o_specs, scalars,
                                         mesh, coord, in_place=in_place)
        assert int(s_l.step) == int(want_s.step)
        for a, b in zip(tree_flatten((local.m, local.v))[0], tree_flatten((s_l.m, s_l.v))[0]):
            assert (a.data_ptr() == b.data_ptr()) == in_place
        for full, part, spec in zip(*(tree_flatten(t)[0] for t in (got_p, p_l)),
                                    port_specs(o_specs.m)):
            full[S.shard_slices(spec, full.shape, mesh, coord)] = part
        for full_t, part_t in ((got_m, s_l.m), (got_v, s_l.v)):
            for full, part, spec in zip(tree_flatten(full_t)[0], tree_flatten(part_t)[0],
                                        port_specs(o_specs.m)):
                full[S.shard_slices(spec, full.shape, mesh, coord)] = part
    for got, want in ((got_p, want_p), (got_m, want_s.m), (got_v, want_s.v)):
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            assert torch.equal(a, b)
    # in place, both shards' updates land in the params given
    for a, b, c in zip(*(tree_flatten(t)[0] for t in (given, want_p, params))):
        assert torch.equal(a, b if in_place else c)


def test_donating_train_cell_updates_its_arguments_bitwise(one_rank):
    """The train cell with ``donate=True`` returns its arguments' storage,
    updated, with the bits of the cell that returns new tensors, over two
    steps."""
    cfg = get_smoke_config("smollm-135m")
    tcfg = TrainConfig(optimizer=opt.AdamWConfig(learning_rate=3e-3, warmup_steps=1))
    mesh = device_mesh((1, 1), ("data", "model"))
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(t[:, sl]) for k, sl in (("tokens", slice(0, -1)),
                                                            ("labels", slice(1, None)))}
               for t in (rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
                         for _ in range(2))]
    runs = {}
    for donate in (False, True):
        with S.use_mesh(mesh, rules_for("train", cfg)):
            cell = SP.build_cell(cfg, ShapeConfig("t", 16, 2, "train"),
                                 mesh, tcfg, donate=donate)
        params = T.init_params(cfg, seed=0, device="cpu")
        state = opt.init_state(params)
        for batch in batches:
            args = (params, state)
            params, state, metrics = cell.fn(params, state, batch)
            same = [a.data_ptr() == b.data_ptr() for a, b in
                    zip(tree_flatten((args[0], args[1].m, args[1].v))[0],
                        tree_flatten((params, state.m, state.v))[0])]
            assert all(same) if donate else not any(same)
        runs[donate] = (params, state, float(metrics["loss"]))
    assert runs[False][2] == runs[True][2]
    for a, b in zip(*(tree_flatten((r[0], r[1].m, r[1].v))[0] for r in runs.values())):
        assert torch.equal(a, b)

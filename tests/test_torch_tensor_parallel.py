"""PyTorch port: the prefill and decode cells tensor-parallel over ``model``
> 1, over 4 gloo ranks on the CPU, against the JAX package's jitted
``build_cell`` on the same mesh shapes.

One spawn of 4 ranks runs every case and writes what each rank holds; one
JAX subprocess per architecture (this file run as a script, with 4 host
devices forced) writes the reference's results; they all run at once, and
the tests compare.
Meshes of 2 ranks are built twice over the 4 (a leading ``rep`` dimension,
sliced off), so every rank works in every case.

Cases: ``llama3-smoke`` (8 heads over 2 KV heads, untied vocab 251 padded
to 256), ``qwen2-smoke`` (6 heads padded to 8 over 2, qkv bias, tied 173 /
176), ``smollm-smoke`` (3 heads padded to 4 over 1, tied 199 / 208) and
``deepseek-smoke`` (4 heads over 4 KV heads, untied 241 / 256), fp32, on ``(1, 2)``, ``(1, 4)`` and ``(2, 2)`` ``("data", "model")`` and
``(2, 1, 2)`` ``("pod", "data", "model")``.  Between them: KV heads split
across ranks (a ``KV·D`` shard that cuts a head), whole KV heads per rank
(the prefill cache split by KV heads), a rank holding padded heads only
(qwen2 over 4), the padded-vocab mask on a rank's columns, and
a batch split over ``data`` (and ``pod``).  Each case runs the prefill cell
over a 12-token prompt into a 16-position cache, then 4 greedy steps of the
decode cell (its cache split by sequence over ``model``).  Held: the
logits and every rank's cache shard within 2e-5 (fp32, relative to the
norm) of the reference's, at the rank's mesh coordinate, and the greedy
tokens equal.

Also here: ``flash_attention``'s ``head_offset`` (the plain version) —
each shard of heads bitwise those heads of the call over every head,
among them a shard of padded heads only; and the tensor-parallel helpers
the identity without a mesh.  The other architectures' cells run in
``test_torch_tp_zoo.py`` (the MoE models and hymba) and
``test_torch_tp_rest.py`` (xLSTM, qwen2-vl, seamless, and a decode cache
split by KV heads).
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
DEADLINE_S = 120

ARCHS = ("llama3-8b", "qwen2-1.5b", "smollm-135m", "deepseek-7b")   # their smoke configs
MESHES = {
    "1x2": ((1, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
}
B, PROMPT, SEQ, STEPS = 2, 12, 16, 4
TOL = 2e-5


# ------------------------------------------------------- shared inputs


def draw_params(leaves, cfg_heads, seed=0):
    """Numpy weights for the (shape, logical axes) leaves in JAX order: norms
    1 + 0.1 N, everything else 0.05 N (biases too, so a rank's bias columns
    matter); the rows of padded query heads in ``wo`` zero, as the JAX
    package's init leaves them."""
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


def prompt(vocab):
    return np.random.default_rng(1).integers(0, vocab, size=(B, PROMPT)).astype(np.int32)


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


def rank_case(out, arch, mname):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import gather_shard, use_mesh
    from repro_torch.interop import from_numpy, to_numpy, tree_flatten, tree_map, tree_unflatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.common import is_tuple
    from repro_torch.models.transformer import param_specs

    cfg = get_smoke_config(arch)
    specs, treedef = tree_flatten(param_specs(cfg))
    leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                         (cfg.num_heads, cfg.head_dim))
    params = tree_unflatten(treedef, [from_numpy(a) for a in leaves])
    mesh = rank_mesh(*MESHES[mname])
    key = f"{arch}/{mname}"
    out[f"{key}/coord"] = np.asarray(mesh.get_coordinate())

    with use_mesh(mesh, rules_for("prefill", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("p", SEQ, B, "prefill"), mesh)
    p_local = SP.local_tree(params, cell.in_specs[0], mesh)
    batch = SP.local_tree({"tokens": from_numpy(prompt(cfg.vocab_size))}, cell.in_specs[1], mesh)
    logits, cache = cell.fn(p_local, batch)
    out[f"{key}/prefill/logits"] = to_numpy(logits)
    for i, t in enumerate(tree_flatten(cache)[0]):
        out[f"{key}/prefill/cache{i}"] = to_numpy(t)
    full_cache = tree_map(lambda t, s: gather_shard(t, s, mesh), cache, cell.out_specs[1],
                          is_leaf=is_tuple)

    with use_mesh(mesh, rules_for("decode", cfg)):
        dcell = SP.build_cell(cfg, ShapeConfig("d", SEQ, B, "decode"), mesh)
    p_local = SP.local_tree(params, dcell.in_specs[0], mesh)
    cache = SP.local_tree(full_cache, dcell.in_specs[1], mesh)
    tokens = logits.argmax(dim=-1).to(torch.int32)
    toks = [to_numpy(tokens)]
    for step in range(STEPS):
        cur = torch.full_like(tokens, PROMPT + step)
        logits, cache = dcell.fn(p_local, cache, tokens, cur)
        out[f"{key}/decode{step}/logits"] = to_numpy(logits)
        tokens = logits.argmax(dim=-1).to(torch.int32)
        toks.append(to_numpy(tokens))
    out[f"{key}/tokens"] = np.stack(toks, axis=1)
    for i, t in enumerate(tree_flatten(cache)[0]):
        out[f"{key}/decode/cache{i}"] = to_numpy(t)


def rank_main(rank, world, pg_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_path}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=DEADLINE_S))
    try:
        out = {}
        for arch in ARCHS:
            for mname in MESHES:
                rank_case(out, arch, mname)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the reference


def reference_main(path, archs):
    """The JAX package's jitted prefill and decode cells on every case of
    ``archs`` (run as a script, 4 host devices).  The cache and tokens go
    back to numpy between calls, so each cell compiles once."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.launch.specs as RSP
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
            for shard in leaf.addressable_shards:
                out[f"{prefix}{i}@{coord_key(pos[shard.device.id])}"] = np.asarray(shard.data)

    for arch in archs:
        cfg = get_smoke_config(arch)
        specs, treedef = jax.tree_util.tree_flatten(
            param_specs(cfg), is_leaf=lambda v: isinstance(v, ParamSpec))
        leaves = draw_params([(s.shape, s.logical_axes) for s in specs],
                             (cfg.num_heads, cfg.head_dim))
        params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
        for mname, (shape, names) in MESHES.items():
            key = f"{arch}/{mname}"
            mesh = Mesh(devs[:math.prod(shape)].reshape(shape), names)
            with use_mesh(mesh, rules_for("prefill", cfg)):
                fn, _ = RSP.build_cell(cfg, ShapeConfig("p", SEQ, B, "prefill"), mesh)
                logits, cache = fn(params, {"tokens": jnp.asarray(prompt(cfg.vocab_size))})
            out[f"{key}/prefill/logits"] = np.asarray(logits)
            shards(f"{key}/prefill/cache", cache, mesh)
            cache = jax.tree_util.tree_map(np.asarray, cache)
            with use_mesh(mesh, rules_for("decode", cfg)):
                dfn, _ = RSP.build_cell(cfg, ShapeConfig("d", SEQ, B, "decode"), mesh)
                toks = [np.asarray(jnp.argmax(logits, axis=-1).astype(jnp.int32))]
                for step in range(STEPS):
                    cur = np.full((B,), PROMPT + step, np.int32)
                    logits, cache = dfn(params, cache, toks[-1], cur)
                    out[f"{key}/decode{step}/logits"] = np.asarray(logits)
                    toks.append(np.asarray(jnp.argmax(logits, axis=-1).astype(jnp.int32)))
                    if step < STEPS - 1:
                        cache = jax.tree_util.tree_map(np.asarray, cache)
            out[f"{key}/tokens"] = np.stack(toks, axis=1)
            shards(f"{key}/decode/cache", cache, mesh)
    np.savez(path, **out)


# -------------------------------------------------------------- the run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference subprocesses (one per architecture; XLA's CPU
    backend at optimisation level 0, which halves its compile time) and the
    4 ranks together; wait for all (within ``DEADLINE_S``); their results
    as dicts."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4"
                          + " --xla_backend_optimization_level=0").strip())
    refs = [subprocess.Popen([sys.executable, __file__, "reference", str(tmp / f"ref{i}.npz"),
                              arch], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i, arch in enumerate(ARCHS)]
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
    for i in range(len(ARCHS)):
        ref.update(np.load(tmp / f"ref{i}.npz"))
    return ref, ranks


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def batch_rows(mname, coord):
    """This coordinate's rows of the batch (split over pod x data)."""
    shape, names = MESHES[mname]
    at = dict(zip(names, coord))
    idx, parts = 0, 1
    for a in ("pod", "data"):
        if a in at:
            idx, parts = idx * dict(zip(names, shape))[a] + at[a], parts * dict(zip(names, shape))[a]
    n = B // parts
    return slice(idx * n, (idx + 1) * n)


CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mname", CASES)
def test_prefill_cell_matches_reference(runs, arch, mname):
    ref, ranks = runs
    key = f"{arch}/{mname}"
    n_cache = sum(1 for k in ranks[0] if k.startswith(f"{key}/prefill/cache"))
    assert n_cache == 3                       # k, v, pos of the one dense segment
    for r in ranks:
        coord = r[f"{key}/coord"]
        want = ref[f"{key}/prefill/logits"][batch_rows(mname, coord)]
        assert rel(r[f"{key}/prefill/logits"], want) < TOL
        for i in range(n_cache):
            got = r[f"{key}/prefill/cache{i}"]
            want = ref[f"{key}/prefill/cache{i}@{coord_key(coord)}"]
            assert got.shape == want.shape, (i, got.shape, want.shape)
            assert rel(got, want) < TOL, i


@pytest.mark.parametrize("arch,mname", CASES)
def test_decode_cell_matches_reference(runs, arch, mname):
    ref, ranks = runs
    key = f"{arch}/{mname}"
    n_model = dict(zip(MESHES[mname][1], MESHES[mname][0]))["model"]
    for r in ranks:
        coord = r[f"{key}/coord"]
        rows = batch_rows(mname, coord)
        np.testing.assert_array_equal(r[f"{key}/tokens"], ref[f"{key}/tokens"][rows])
        for step in range(STEPS):
            assert rel(r[f"{key}/decode{step}/logits"],
                       ref[f"{key}/decode{step}/logits"][rows]) < TOL, step
        for i in range(3):
            got = r[f"{key}/decode/cache{i}"]
            want = ref[f"{key}/decode/cache{i}@{coord_key(coord)}"]
            assert got.shape == want.shape, (i, got.shape, want.shape)
            assert got.shape[2] == SEQ // n_model          # split by sequence
            if got.dtype.kind == "i":                       # pos: exact
                np.testing.assert_array_equal(got, want)
            else:
                assert rel(got, want) < TOL, i


# ------------------------------------------- flash_attention's head_offset


OFFSET_CASES = [    # (B, padded heads, real heads, KVH, Sq, Sk, D, causal, window, ranks)
    (2, 8, 6, 2, 24, 24, 8, True, None, 4),        # qwen2 smoke: rank 3 padded heads only
    (2, 8, 6, 2, 24, 24, 8, True, None, 2),        # 4 real + ... rank 1: heads 4-5 real
    (1, 8, 8, 2, 33, 33, 8, True, None, 4),        # llama3 smoke: a KV group over 2 ranks
    (2, 4, 3, 1, 20, 20, 16, True, None, 4),       # smollm smoke: 3 of 4 over 1 KV head
    (1, 16, 12, 2, 40, 40, 32, True, 7, 2),        # window
    (2, 8, 8, 4, 17, 29, 16, False, None, 4),      # Sq != Sk, no mask
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,nh,kvh,sq,sk,d,causal,window,ranks", OFFSET_CASES)
def test_flash_head_offset_shards_are_bitwise_the_full_call(dtype, b, h, nh, kvh, sq, sk, d,
                                                           causal, window, ranks):
    """Each rank's heads through the plain version (``ops`` on CPU tensors)
    with ``head_offset``: bitwise those heads of the call over every head;
    a shard past ``num_heads`` is zeros."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               .transpose(1, 2) for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    kw = dict(causal=causal, window=window, num_heads=nh)
    full = flash_attention(q, k, v, **kw)
    per = h // ranks
    for r in range(ranks):
        part = flash_attention(q[:, r * per:(r + 1) * per], k, v, head_offset=r * per, **kw)
        assert torch.equal(part, full[:, r * per:(r + 1) * per]), r
        if r * per >= nh:
            assert (part == 0).all()
    assert (full[:, nh:] == 0).all() and full[:, :nh].abs().sum() > 0


# ------------------------------------------------ helpers without a mesh


def test_helpers_are_the_identity_without_a_mesh():
    from repro_torch.distributed.sharding import MeshSpec, use_mesh
    from repro_torch.distributed.tensor_parallel import (all_gather, all_reduce_max,
                                                         all_reduce_sum, shard_of)

    t = torch.arange(6.0)
    for ctx in (None, MeshSpec(("data", "model"), (1, 4))):     # no mesh; an abstract one
        with use_mesh(ctx):
            sh = shard_of("heads", 64)
            assert (sh.offset, sh.size, sh.total, sh.split) == (0, 64, 64, False)
            assert all_reduce_sum(t, sh) is t and all_reduce_max(t, sh) is t
            assert all_gather(t, 0, sh) is t


def test_host_mesh_with_a_model_axis(tmp_path):
    """``make_host_mesh(model=)`` on a 1-rank gloo group: a (1, 1) ``("data",
    "model")`` mesh; a model size that does not divide the world refused."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    init_process_group("cpu", f"file://{tmp_path / 'store'}")
    try:
        mesh = make_host_mesh("cpu", model=1)
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert make_host_mesh("cpu").mesh_dim_names == ("data",)
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh("cpu", model=2)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2], sys.argv[3:])

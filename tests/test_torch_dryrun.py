"""PyTorch port: the dry run's execution (``launch/dryrun.py``,
``launch/accounting.py``) and the kernels' meta implementations
(``kernels/meta.py``).

The JAX package's dry run cannot be the oracle of the new fields: its own
run does not start on the production meshes under this jax, and its
``collective_bytes`` reads 0 bytes from this XLA's HLO text (ROADMAP.md,
the reference's divergences).  So each field is held against what the port
really executes:

(a) The smoke configs of smollm-135m, mixtral (TP-MoE), phi3.5-moe (EP),
    hymba, xlstm and seamless, each cell kind at batch 2 x 16 on a (1, 4)
    ``("data", "model")`` mesh: the meta run (rank 0's program under a
    fake group of 4, in a child process) against the same cell executed by
    4 gloo ranks with real CPU tensors drawn from a seed, counted on rank 0
    by the same ``Accounting`` mode, the kernel ops standing in as their
    kernels (the plain version's output copied into a tensor of the
    kernel's layout, its own ops uncounted).  The collectives equal, kind
    by kind, in count and bytes; the flops without the kernels' share equal
    ``FlopCounterMode``'s over the real run; the peak within 5 %.
(b) smollm-135m's smoke prefill, decode and train cells at world size 1
    (train with remat): the flops equal a closed form written here from the
    config.
(c) Each kernel's meta implementation: the output shapes and dtypes of the
    JAX package's kernel (``jax.eval_shape``) and the port's plain version,
    the kernel's layout, the formula's flops and bytes (causal, windowed,
    Sq != Sk, a tensor-parallel shard's heads), no launch; on a CUDA tensor
    ``"auto"`` still names the kernel.
(d) Four production cells at full depth on 256 and 512 devices (a train, a
    prefill, a decode and an MoE cell) through ``run_cells``: ``ok``, every
    new field, ``peak_bytes >= argument_bytes``.
(e) The JAX package's dry-run accounting of smollm-135m smoke's three cells
    on a (1, 4) mesh of 4 host devices (its compiled HLO through
    ``repro.launch.dryrun.collective_bytes``): every collective kind the
    port issues appears there too.  Its bytes are not compared: that parser
    reads 0 bytes from this XLA's HLO text, and the all-to-alls and
    permutes its partitioner adds have no counterpart in the port.
(f) hymba's prefill with a prompt of the cache's length behind its meta
    tokens (the production prefill cells' shape): the port keeps the
    reference's cache, whose scatter drops the writes past its end.

One spawn of 4 gloo ranks runs (a)'s real cells and one subprocess (e)'s
compile while this process runs the meta cells in child processes; the
whole file takes ~40 s.  Run as a script, ``python
tests/test_torch_dryrun.py collectives`` prints the port's and the
reference's collective counts and bytes of (e)'s three cells side by side.
"""

import functools
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import meta as KM
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.page_gather.ops import page_gather, page_scatter
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.launch.accounting import COLLECTIVE_KINDS
from repro_torch.launch.dryrun import account_cells, run_cells

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORLD = 4
MESH = ((1, WORLD), ("data", "model"))
ARCHS = ("smollm-135m", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "xlstm-1.3b",
         "seamless-m4t-medium")
KINDS = ("prefill", "decode", "train")
SEQ, BATCH = 16, 2
CASES = [(a, k) for a in ARCHS for k in KINDS]
PEAK_TOL = 0.05
DEADLINE_S = 120
PRODUCTION = [("smollm-135m", "train_4k", False), ("llama3-8b", "prefill_32k", True),
              ("qwen2-1.5b", "decode_32k", False), ("mixtral-8x7b", "decode_32k", True)]


def shape_of(kind: str) -> ShapeConfig:
    return ShapeConfig(f"{kind}_test", SEQ, BATCH, kind)


# ------------------------------------------------------------- the ranks


def real_args(cfg, shape, cell, mesh):
    """This rank's shards of real CPU arguments for the cell: weights from
    seed 0, inputs from seed 1 (ids below the vocabulary, floats standard
    normal), a zero cache, the decode at position SEQ // 2."""
    from repro_torch import torch_dtype
    from repro_torch.launch.specs import local_tree
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import init_state

    gen = torch.Generator().manual_seed(1)

    def like(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen).to(t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen, dtype=t.dtype)

    params = T.init_params(cfg, seed=0, device="cpu")
    if shape.kind == "train":
        args = (params, init_state(params), {k: like(v) for k, v in cell.args[2].items()})
    elif shape.kind == "prefill":
        args = (params, {k: like(v) for k, v in cell.args[1].items()})
    else:
        cache = T.init_cache(cfg, BATCH, SEQ, torch_dtype(cfg.compute_dtype), device="cpu",
                             memory_len=SEQ if cfg.is_encdec else None)
        args = (params, cache, like(cell.args[2]),
                torch.full((BATCH,), SEQ // 2, dtype=torch.int32))
    return [local_tree(a, s, mesh) for a, s in zip(args, cell.in_specs)]


def as_kernel(plain):
    """``plain`` (a flash_attention op) standing in for its kernel: its
    result computed with every mode off, then copied into an output of the
    kernel's layout made under the modes (its storage counted, no flops)."""
    from torch.utils._python_dispatch import _disable_current_modes

    def run(q, k, v, **kw):
        with _disable_current_modes():
            o = plain(q, k, v, **kw)
        b, h, sq, d = q.shape
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
        with _disable_current_modes():
            out.copy_(o)
        return out
    return run


def rank_main(rank, world, pg_path, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.accounting import Accounting
    from repro_torch.launch.mesh import rules_for
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import blocks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_path}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=DEADLINE_S))
    try:
        mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
        blocks.flash_attention = as_kernel(blocks.flash_attention)
        out = {}
        for arch, kind in CASES:
            cfg, shape = get_smoke_config(arch), shape_of(kind)
            with use_mesh(mesh, rules_for(kind, cfg)):
                cell = build_cell(cfg, shape, mesh)
            args = real_args(cfg, shape, cell, mesh)
            with FlopCounterMode(display=False) as fc, Accounting("cpu") as acc:
                acc.track(args)
                res = cell.fn(*args)
                del res
            out[f"{arch}/{kind}"] = {"flops": fc.get_total_flops(), "peak": acc.peak,
                                     "collectives": acc.collectives}
        if rank == 0:
            Path(out_path).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------- the runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(real: rank 0's counts by case, meta: the accounting by case (and
    ``"ws1/<kind>"`` for (b)), production: the records of (d))."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("dryrun")
    t0 = time.monotonic()
    ref = start_reference(tmp / "reference.json")
    ctx = mp.start_processes(rank_main, args=(WORLD, str(tmp / "pg"), str(tmp / "real.json")),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        jobs = [(get_smoke_config(a), shape_of(k), *MESH, None) for a, k in CASES]
        smollm = get_smoke_config("smollm-135m")
        jobs += [(smollm.replace(remat="full") if k == "train" else smollm, shape_of(k),
                  (1, 1), ("data", "model"), None) for k in KINDS]
        res = account_cells(jobs, workers=2)
        meta = dict(zip([f"{a}/{k}" for a, k in CASES] + [f"ws1/{k}" for k in KINDS], res))
        production = run_cells(PRODUCTION, tmp / "records", workers=2)
        while not ctx.join(timeout=max(1.0, DEADLINE_S - (time.monotonic() - t0))):
            if time.monotonic() - t0 > DEADLINE_S:
                pytest.fail(f"the ranks did not finish in {DEADLINE_S} s")
        log, _ = ref.communicate(timeout=max(1.0, DEADLINE_S - (time.monotonic() - t0)))
        assert ref.returncode == 0, log
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    real = json.loads((tmp / "real.json").read_text())
    meta["reference"] = json.loads((tmp / "reference.json").read_text())
    return real, meta, production


def executed(meta, key):
    rec = meta[key]
    assert "error" not in rec, rec.get("traceback")
    return rec


# ------------------------------------------------------- the reference


def start_reference(path):
    """This file run as a script (``reference PATH``) with 4 host devices
    forced, XLA at optimisation level 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + f" --xla_force_host_platform_device_count={WORLD}"
                          + " --xla_backend_optimization_level=0").strip())
    return subprocess.Popen([sys.executable, __file__, "reference", str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def reference_main(path):
    """The JAX package's accounting of smollm-135m smoke's cells on a (1, 4)
    ``Mesh`` of the host devices: ``collective_bytes`` of each compiled
    cell's HLO, by kind."""
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:WORLD])       # the backend is fixed at 4 devices now
    from repro.configs.base import ShapeConfig as RShapeConfig
    from repro.configs.registry import get_smoke_config as ref_smoke
    from repro.distributed.sharding import use_mesh as ref_use_mesh
    from repro.launch import specs as RSP
    from repro.launch.dryrun import collective_bytes
    from repro.launch.mesh import rules_for as ref_rules_for

    cfg = ref_smoke("smollm-135m")
    mesh = Mesh(devs.reshape(MESH[0]), MESH[1])
    out = {}
    for kind in KINDS:
        with ref_use_mesh(mesh, ref_rules_for(kind, cfg)):
            fn, args = RSP.build_cell(cfg, RShapeConfig(kind, SEQ, BATCH, kind), mesh)
            out[kind] = collective_bytes(fn.lower(*args).compile().as_text())
    Path(path).write_text(json.dumps(out))


# -------------------------------------------------------------------- (a)


@pytest.mark.parametrize("arch,kind", CASES)
def test_collectives_equal_real_gloo_ranks(runs, arch, kind):
    real, meta, _ = runs
    got = executed(meta, f"{arch}/{kind}")["collectives"]
    assert got == real[f"{arch}/{kind}"]["collectives"]
    assert set(got["counts"]) == set(COLLECTIVE_KINDS)


@pytest.mark.parametrize("arch,kind", CASES)
def test_flops_without_kernels_equal_real_execution(runs, arch, kind):
    real, meta, _ = runs
    rec = executed(meta, f"{arch}/{kind}")
    kernel_flops = sum(k["flops"] for k in rec["kernels"].values())
    assert rec["flops"] - kernel_flops == real[f"{arch}/{kind}"]["flops"]
    assert (kernel_flops > 0) == (kind == "prefill" and arch != "xlstm-1.3b")


@pytest.mark.parametrize("arch,kind", CASES)
def test_peak_within_five_percent_of_real_execution(runs, arch, kind):
    real, meta, _ = runs
    got, want = executed(meta, f"{arch}/{kind}")["peak_bytes"], real[f"{arch}/{kind}"]["peak"]
    assert abs(got - want) <= PEAK_TOL * want, (got, want)


# -------------------------------------------------------------------- (b)


def smollm_closed_form(kind: str) -> int:
    """smollm-135m smoke's cell flops at world size 1, from the config: the
    matmuls ``2 · tokens · params`` (every weight as stored, padded heads
    included), the attention as each route computes it, the LM head on
    the tokens it reads."""
    cfg = get_smoke_config("smollm-135m")
    E, H, KV, D, F = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    layer = E * H * D + 2 * E * KV * D + H * D * E + 3 * E * F
    L, V = cfg.num_layers, cfg.padded_vocab
    if kind == "prefill":
        # the kernel's formula on the real heads, the causal half only; the
        # logits of the last position
        attn = 4 * BATCH * cfg.num_heads * D * (SEQ * (SEQ + 1) // 2)
        return L * (2 * BATCH * SEQ * layer + attn) + 2 * BATCH * E * V
    if kind == "decode":
        # one token against the whole cache (padded heads: the KV expanded)
        return L * (2 * BATCH * layer + 4 * BATCH * H * SEQ * D) + 2 * BATCH * E * V
    # training attention at 16 x 16 takes the dense route (Sq * Sk <= 1024^2):
    # QK^T and PV forward, two products for each backward; the layer's
    # forward runs again in the backward (remat), up to its last saved
    # tensor: checkpoint's recompute stops before w_down, whose input is
    # the last thing the backward needs
    attn = 4 * BATCH * H * SEQ * SEQ * D
    fwd = 2 * BATCH * SEQ * layer + attn
    recompute = fwd - 2 * BATCH * SEQ * F * E
    bwd = 2 * (2 * BATCH * SEQ * layer) + 2 * attn
    head = 2 * BATCH * SEQ * E * V
    return L * (fwd + recompute + bwd) + 3 * head


@pytest.mark.parametrize("kind", KINDS)
def test_smollm_flops_equal_closed_form_at_world_size_one(runs, kind):
    _, meta, _ = runs
    assert executed(meta, f"ws1/{kind}")["flops"] == smollm_closed_form(kind)


# -------------------------------------------------------------------- (c)


def brute_visible(sq, sk, causal, window):
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= q - k < window
    return int(ok.sum())


@pytest.mark.parametrize("sq,sk", [(1, 1), (7, 7), (33, 20), (20, 33), (64, 64), (5, 40)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 4, 16, 100])
def test_visible_keys_closed_form(sq, sk, causal, window):
    assert KM.visible_keys(sq, sk, causal, window) == brute_visible(sq, sk, causal, window)


def counted(fn):
    """(result, the calls / flops / bytes it added to meta_costs, launches)."""
    K.reset_meta_costs()
    K.reset_launch_counts()
    out = fn()
    costs = {k: dict(v) for k, v in K.meta_costs.items() if v["calls"]}
    return out, costs, sum(K.launch_counts.values())


FLASH = [  # (B, H, KVH, Sq, Sk, D, causal, window, num_heads, head_offset, dtype)
    (2, 4, 2, 24, 24, 16, True, None, None, 0, torch.bfloat16),
    (1, 6, 3, 40, 40, 32, True, 9, None, 0, torch.float32),
    (2, 4, 1, 12, 30, 16, False, None, None, 0, torch.bfloat16),
    (1, 2, 2, 30, 12, 8, True, 5, None, 0, torch.float32),
    (2, 4, 1, 20, 20, 16, True, None, 6, 4, torch.bfloat16),     # rank 1 of 2: 2 real heads
]


@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_meta_is_the_kernel(case):
    b, h, kvh, sq, sk, d, causal, window, nh, h0, dt = case
    q = torch.empty((b, sq, h, d), dtype=dt, device="meta").transpose(1, 2)
    k = torch.empty((b, sk, kvh, d), dtype=dt, device="meta").transpose(1, 2)
    v = torch.empty_like(k)
    out, costs, launches = counted(lambda: flash_attention(q, k, v, causal=causal,
                                                           window=window, num_heads=nh,
                                                           head_offset=h0))
    real = (nh if nh is not None else h0 + h) - h0
    real = min(real, h)
    rep = (nh or h0 + h) // kvh
    groups = (h0 + real - 1) // rep - h0 // rep + 1
    isz = q.element_size()
    want_flops = 4 * b * real * d * brute_visible(sq, sk, causal, window)
    want_bytes = (b * real * sq * d + 2 * b * groups * sk * d + b * h * sq * d) * isz
    assert costs == {"flash_attention": {"calls": 1, "flops": want_flops, "bytes": want_bytes}}
    assert launches == 0
    assert out.is_meta and out.shape == (b, h, sq, d) and out.dtype == dt
    assert out.transpose(1, 2).is_contiguous()          # [B, Sq, H, D] in memory
    cpu = [torch.zeros(t.shape, dtype=t.dtype) for t in (q, k, v)]
    plain = flash_attention_ref(*cpu, causal=causal, window=window, num_heads=nh,
                                head_offset=h0)
    assert plain.shape == out.shape and plain.dtype == out.dtype
    if nh is None and h0 == 0:
        from repro.kernels.flash_attention.kernel import flash_attention as ref_kernel
        jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
        want = jax.eval_shape(functools.partial(ref_kernel, causal=causal, window=window,
                                                interpret=True),
                              *(jax.ShapeDtypeStruct(tuple(t.shape), jdt) for t in (q, k, v)))
        assert tuple(want.shape) == tuple(out.shape) and want.dtype == jdt


@pytest.mark.parametrize("window", [None, 20])
def test_paged_attention_meta_is_the_kernel(window):
    b, h, kvh, d, pages, ps, pps = 3, 8, 2, 16, 12, 4, 8
    q = torch.empty((b, h, d), dtype=torch.bfloat16, device="meta")
    pool = torch.empty((pages, ps, kvh, d), dtype=torch.bfloat16, device="meta")
    table = torch.empty((b, pps), dtype=torch.int32, device="meta")
    lengths = torch.empty((b,), dtype=torch.int32, device="meta")
    out, costs, launches = counted(lambda: paged_attention(q, pool, pool, table, lengths,
                                                           num_heads=6, window=window))
    keys = pps * ps if window is None else min(pps * ps, window)
    want_bytes = (b * 6 * d + 2 * b * keys * kvh * d + b * h * d) * 2 + b * pps * 4 + b * 4
    assert costs == {"paged_attention": {"calls": 1, "flops": 4 * b * 6 * keys * d,
                                         "bytes": want_bytes}}
    assert launches == 0 and out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    plain = paged_attention_ref(torch.zeros(q.shape, dtype=q.dtype),
                                torch.zeros(pool.shape, dtype=q.dtype),
                                torch.zeros(pool.shape, dtype=q.dtype),
                                torch.zeros(table.shape, dtype=torch.int32),
                                torch.full((b,), 5, dtype=torch.int32), num_heads=6)
    assert plain.shape == out.shape and plain.dtype == out.dtype
    from repro.kernels.paged_attention.kernel import paged_attention as ref_kernel
    want = jax.eval_shape(functools.partial(ref_kernel, interpret=True),
                          jax.ShapeDtypeStruct((b, h, d), jnp.bfloat16),
                          *(jax.ShapeDtypeStruct(tuple(pool.shape), jnp.bfloat16),) * 2,
                          jax.ShapeDtypeStruct((b, pps), jnp.int32),
                          jax.ShapeDtypeStruct((b,), jnp.int32))
    assert tuple(want.shape) == tuple(out.shape)


@pytest.mark.parametrize("layers", [None, 3])
def test_page_copies_meta_are_the_kernels(layers):
    P, E, n = 10, 24, 4
    lead = () if layers is None else (layers,)
    pool = torch.empty(lead + (P, E), dtype=torch.float32, device="meta")
    ids = torch.empty((n,), dtype=torch.int32, device="meta")
    want_bytes = 2 * (layers or 1) * n * E * 4
    out, costs, launches = counted(lambda: page_gather(pool, ids))
    assert costs == {"page_gather": {"calls": 1, "flops": 0, "bytes": want_bytes}}
    assert launches == 0 and out.is_meta and out.shape == lead + (n, E)
    pages = torch.empty(lead + (n, E), dtype=torch.float32, device="meta")
    back, costs, launches = counted(lambda: page_scatter(pool, ids, pages))
    assert back is pool and launches == 0
    assert costs == {"page_scatter": {"calls": 1, "flops": 0, "bytes": want_bytes}}
    if layers is None:
        from repro.kernels.page_gather.kernel import page_gather as ref_gather
        want = jax.eval_shape(functools.partial(ref_gather, interpret=True),
                              jax.ShapeDtypeStruct((P, E), jnp.float32),
                              jax.ShapeDtypeStruct((n,), jnp.int32))
        assert tuple(want.shape) == tuple(out.shape)


def test_auto_on_a_cuda_tensor_still_names_the_kernel(monkeypatch):
    """``"auto"`` resolves by device: meta -> the meta implementation, CPU
    -> the plain version, CUDA -> the kernel (which raises here, without a
    card, rather than fall back)."""
    import repro_torch.kernels.flash_attention.ops as fops

    calls = []
    monkeypatch.setattr(fops, "_cuda", lambda *a, **kw: calls.append("cuda"))
    q = torch.zeros((1, 2, 4, 8))
    fake_cuda = type("FakeCuda", (), {"is_cuda": True, "is_meta": False})()
    fops.flash_attention(fake_cuda, q, q)
    assert calls == ["cuda"]
    assert flash_attention(q, q, q).device.type == "cpu"
    with pytest.raises(ValueError, match="meta"):
        flash_attention(q, q, q, impl="nope")


# -------------------------------------------------------------------- (d)


def test_production_cells_execute_with_every_field(runs):
    _, _, recs = runs
    assert [(r["arch"], r["shape"], r["devices"]) for r in recs] == \
        [(a, s, 512 if m else 256) for a, s, m in PRODUCTION]
    for r in recs:
        assert r["ok"], r.get("traceback")
        mem = r["memory"]
        for key in ("flops", "bytes_accessed", "collectives", "run_s", "kernels", "fits"):
            assert key in r, (r["arch"], r["shape"], key)
        assert set(r["collectives"]) == set(COLLECTIVE_KINDS) | {"total", "counts"}
        assert r["collectives"]["total"] == sum(r["collectives"][k] for k in COLLECTIVE_KINDS)
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
        assert r["fits"] == (mem["peak_bytes"] <= r["hbm_bytes"])
        assert r["flops"] > 0 and r["bytes_accessed"] > 0 and r["collectives"]["total"] > 0
    assert "flash_attention" in recs[1]["kernels"]


def test_hymba_prefill_of_the_cache_length_keeps_the_reference_cache():
    """The production prefill cells hand hymba a prompt of the cache's
    length behind its meta tokens: more positions than slots.  The
    reference's scatter drops the writes past the cache's end; the port
    keeps the same first tokens (it raised ``IndexError`` on real tensors
    before): the hidden and every cache leaf within 1e-4, fp32."""
    import repro.models as RM
    import repro_torch.models as M
    from repro.configs.registry import get_smoke_config as ref_smoke_config
    from repro_torch.interop import tree_flatten, tree_map

    cfg = get_smoke_config("hymba-1.5b")
    assert cfg.num_meta_tokens > 0
    params = M.init_params(cfg, seed=0, device="cpu")
    ref_params = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, size=(BATCH, SEQ))
    prompt = prompt.astype(np.int32)
    ref_cfg = ref_smoke_config("hymba-1.5b")
    rh, rc = jax.jit(functools.partial(RM.prefill, ref_cfg))(
        ref_params, {"tokens": jnp.asarray(prompt)}, RM.init_cache(ref_cfg, BATCH, SEQ))
    th, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)},
                       M.init_cache(cfg, BATCH, SEQ, device="cpu"))
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-4, rtol=1e-4)
    got, want = tree_flatten(tc)[0], jax.tree_util.tree_leaves(rc)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=1e-4, rtol=1e-4)


# -------------------------------------------------------------------- (e)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_compiles_every_collective_kind_the_port_issues(runs, kind):
    _, meta, _ = runs
    port = executed(meta, f"smollm-135m/{kind}")["collectives"]["counts"]
    ref = meta["reference"][kind]["counts"]
    assert {k for k, n in port.items() if n} <= {k for k, n in ref.items() if n}, (port, ref)


def print_collectives_table() -> None:
    """(e)'s three cells: the port's meta run and the reference's compiled
    HLO, counts and bytes by kind."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ref = start_reference(Path(tmp) / "reference.json")
        cfg = get_smoke_config("smollm-135m")
        port = account_cells([(cfg, shape_of(k), *MESH, None) for k in KINDS])
        log, _ = ref.communicate(timeout=DEADLINE_S)
        assert ref.returncode == 0, log
        refs = json.loads((Path(tmp) / "reference.json").read_text())
    for kind, p in zip(KINDS, port):
        print(json.dumps({"cell": f"smollm-135m smoke {kind} {BATCH} x {SEQ} on (1, 4)",
                          "port": p["collectives"], "reference": refs[kind]}))


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["collectives"]:
    print_collectives_table()

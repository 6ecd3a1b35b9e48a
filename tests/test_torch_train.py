"""PyTorch port: the training core against the JAX package, on the CPU.

``repro_torch/train/{optimizer,loss,train_step,trainer}.py``,
``models/layers.py``'s flash-VJP attention, ``models/transformer.py``'s
``forward_train``, ``ckpt/checkpoint.py`` and ``launch/train.py``, held to
the reference on the same numpy inputs (the reference's weights cross
through ``params=`` / ``params_from_numpy``).  Models: the smollm smoke
config and the tiny config of ``tests/test_train_ooc.py``.

Tolerances, fp32:
* ``lr_schedule``, ``update_scalars``, ``adamw_elementwise``,
  ``apply_update``: rtol 1e-6.  Measured: the schedule and the scalars
  bitwise equal at every step here; of ``adamw_elementwise``'s 4099
  elements, m and v bitwise equal and one parameter one ulp apart (XLA's
  CPU code may fuse ``p - lr * delta`` into one rounding);
* ``chunked_cross_entropy`` value and its gradient with respect to
  ``hidden``; the flash-VJP attention's output and ``dq``, ``dk``, ``dv``;
  ``forward_train``: atol = rtol = 2e-5;
* three steps of ``train_step`` / ``Trainer.fit``: losses rtol 1e-5;
  parameters atol 5e-5 + rtol 1e-5 (an element whose gradient changes sign
  by rounding may move up to 2·lr a step; lr <= 9e-6 over the first three
  steps at the default warmup); m and v within 1e-4 of their norm.
Bitwise, within the port: ``adamw_elementwise`` over chunks against whole
leaves, and ``remat="full"`` against ``"none"``.  Bitwise against the
reference: checkpoint ``.npy`` files and store images of the same tree, and
restores both ways.
"""

import json
import math
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as rckpt
import repro.models as RM
import repro.models.layers as RL
import repro.train.loss as rloss
import repro.train.optimizer as ropt
import repro.train.train_step as rts
import repro.train.trainer as rtrainer
import repro_torch.ckpt.checkpoint as ckpt
import repro_torch.models.layers as L
import repro_torch.models.transformer as T
import repro_torch.train.loss as loss
import repro_torch.train.optimizer as opt
import repro_torch.train.train_step as ts
import repro_torch.train.trainer as trainer
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import HostArrayStore
from repro_torch.interop import params_from_numpy, to_numpy, tree_flatten, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(atol=2e-5, rtol=2e-5)
STEP_TOL = dict(loss=1e-5, atol=5e-5, rtol=1e-5, moments=1e-4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference numpy params, port cfg, port params)."""
    ref_cfg = ref_smoke_config("smollm-135m")
    ref_params = np_tree(RM.init_params(ref_cfg, jax.random.key(0)))
    cfg = get_smoke_config("smollm-135m")
    return ref_cfg, ref_params, cfg, params_from_numpy(ref_params, "cpu", cfg=cfg)


def batches(cfg, n, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()})
    return out


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_state_close(got_params, got_m, got_v, ref_params, ref_m, ref_v):
    for g, r in zip(tree_flatten(got_params)[0], jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(to_numpy(g), np.asarray(r),
                                   atol=STEP_TOL["atol"], rtol=STEP_TOL["rtol"])
    for got, ref in ((got_m, ref_m), (got_v, ref_v)):
        for g, r in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(ref)):
            r = np.asarray(r)
            assert np.linalg.norm(to_numpy(g) - r) <= STEP_TOL["moments"] * max(
                np.linalg.norm(r), 1e-30)


# ----------------------------------------------------------------- optimizer


ACFG = dict(learning_rate=3e-4, warmup_steps=100, total_steps=1000)


@pytest.mark.parametrize("step", [0, 1, 7, 99, 100, 101, 550, 999, 5000])
def test_lr_schedule_and_update_scalars_match_reference(step):
    cfg, rcfg = opt.AdamWConfig(**ACFG), ropt.AdamWConfig(**ACFG)
    got = opt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = ropt.lr_schedule(rcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for gnorm in (0.25, 3.5):
        got = opt.update_scalars(cfg, torch.tensor(step, dtype=torch.int32),
                                 torch.tensor(gnorm, dtype=torch.float32))
        want = ropt.update_scalars(rcfg, jnp.asarray(step, jnp.int32),
                                   jnp.asarray(gnorm, jnp.float32))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.dim() == 0
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def adamw_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 1e-3
    rcfg = ropt.AdamWConfig(**ACFG)
    scalars = [np.array(s) for s in ropt.update_scalars(
        rcfg, jnp.asarray(4, jnp.int32), jnp.asarray(2.5, jnp.float32))]
    return (p, g, m, v), scalars


def test_adamw_elementwise_matches_reference():
    arrays, scalars = adamw_inputs(4099)
    got = opt.adamw_elementwise(opt.AdamWConfig(**ACFG),
                                *(torch.from_numpy(a) for a in arrays),
                                *(torch.from_numpy(s) for s in scalars))
    want = ropt.adamw_elementwise(ropt.AdamWConfig(**ACFG),
                                  *(jnp.asarray(a) for a in arrays),
                                  *(jnp.asarray(s) for s in scalars))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("bounds", [[0, 1, 1000, 1024, 3000, 4099], [0, 7, 8, 2049, 4099]])
def test_adamw_elementwise_is_chunk_invariant(bounds):
    arrays, scalars = adamw_inputs(4099, seed=1)
    cfg = opt.AdamWConfig(**ACFG)
    ts_ = [torch.from_numpy(a) for a in arrays]
    sc = [torch.from_numpy(s) for s in scalars]
    whole = opt.adamw_elementwise(cfg, *ts_, *sc)
    parts = [opt.adamw_elementwise(cfg, *(t[lo:hi] for t in ts_), *sc)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    for i, w in enumerate(whole):
        assert torch.equal(torch.cat([p[i] for p in parts]), w)


def test_apply_update_matches_reference():
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": [rng.standard_normal(11).astype(np.float32)]}
    grads = jax.tree_util.tree_map(lambda a: 3 * rng.standard_normal(a.shape)
                                   .astype(np.float32), params)
    cfg, rcfg = opt.AdamWConfig(**ACFG), ropt.AdamWConfig(**ACFG)
    tp, tg = tree_map(torch.from_numpy, params), tree_map(torch.from_numpy, grads)
    tstate, rstate = opt.init_state(tp), ropt.init_state(params)
    for _ in range(3):
        tp, tstate, tm = opt.apply_update(cfg, tp, tg, tstate)
        params, rstate, rm = ropt.apply_update(rcfg, params, grads, rstate)
    assert isinstance(tstate, opt.AdamWState) and tstate.step.dtype == torch.int32
    assert int(tstate.step) == int(rstate.step) == 3
    for got, want in ((tp, params), (tstate.m, rstate.m), (tstate.v, rstate.v)):
        for g, w in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)


# ---------------------------------------------------------------------- loss


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_value_and_grad_match_reference(smoke, masked):
    ref_cfg, ref_params, cfg, params = smoke
    rng = np.random.default_rng(5)
    b, s = 2, 13                                    # 13 = 2 chunks of 5 + 3 padded
    hidden = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.7 if masked else None

    def ref_fn(h):
        return rloss.chunked_cross_entropy(
            ref_cfg, ref_params, h, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk=5, z_loss_coeff=1e-4)

    (rl, rm), rgrad = jax.value_and_grad(ref_fn, has_aux=True)(jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_(True)
    tl, tm = loss.chunked_cross_entropy(
        cfg, params, h, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), chunk=5, z_loss_coeff=1e-4)
    (tgrad,) = torch.autograd.grad(tl, h)
    np.testing.assert_allclose(tl.item(), float(rl), **TOL)
    np.testing.assert_allclose(tm["nll"].item(), float(rm["nll"]), **TOL)
    assert tm["tokens"].item() == float(rm["tokens"])
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(rgrad), **TOL)


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("window", [None, 8])
def test_flash_vjp_attention_matches_reference_grads(window):
    """Output and dq, dk, dv at a ragged length (37, chunks of 16), GQA."""
    rng = np.random.default_rng(7)
    b, s, h, kvh, d = 2, 37, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    rspec = RL.AttnSpec(causal=True, window=window, impl="chunked", chunk_size=16)
    ro, vjp = jax.vjp(lambda q_, k_, v_: RL._flash_vjp_attention(
        q_, k_, v_, rspec, jnp.asarray(pos), jnp.asarray(pos), None),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    rgrads = vjp(jnp.asarray(do))

    spec = L.AttnSpec(causal=True, window=window, impl="chunked", chunk_size=16)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    to = L.attention(tq, tk, tv, spec, tpos, tpos)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(ro), **TOL)
    for g, r in zip(tgrads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ------------------------------------------------------------- forward_train


@pytest.mark.parametrize("seq", [24, 1040])          # 1040² > 1024²: chunked
def test_forward_train_matches_reference(smoke, seq):
    ref_cfg, ref_params, cfg, params = smoke
    tokens = np.random.default_rng(seq).integers(0, cfg.vocab_size, (1, seq)).astype(np.int32)
    rh, raux = jax.jit(partial(RM.forward_train, ref_cfg))(
        ref_params, {"tokens": jnp.asarray(tokens)})
    th, taux = T.forward_train(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert taux == {} and not raux
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **TOL)


def test_remat_full_is_bitwise_remat_none(smoke):
    _, _, cfg, params = smoke
    (batch,) = batches(cfg, 1)
    tcfg = ts.TrainConfig(loss_chunk=8)
    out = [ts.value_and_grad(cfg.replace(remat=r), tcfg, params, tbatch(batch))
           for r in ("none", "full")]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_flatten(out[0][2])[0], tree_flatten(out[1][2])[0]):
        assert torch.equal(a, b)


# --------------------------------------------------------------- train step


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_three_steps_match_reference(smoke, microbatches):
    ref_cfg, ref_params, cfg, params = smoke
    tcfg = ts.TrainConfig(loss_chunk=8, microbatches=microbatches)
    rtcfg = rts.TrainConfig(loss_chunk=8, microbatches=microbatches)
    rstep = jax.jit(partial(rts.train_step, ref_cfg, rtcfg))
    rp, rs = ref_params, ropt.init_state(ref_params)
    tp, tstate = params, opt.init_state(params)
    for batch in batches(cfg, 3, b=4):
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, tm = ts.train_step(cfg, tcfg, tp, tstate, tbatch(batch))
        np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]), rtol=STEP_TOL["loss"])
        np.testing.assert_allclose(tm["grad_norm"].item(), float(rm["grad_norm"]), rtol=1e-4)
    assert int(tstate.step) == 3
    assert_state_close(tp, tstate.m, tstate.v, rp, rs.m, rs.v)


def trainer_cfgs(ckpt_dir=None):
    kw = dict(total_steps=3, log_every=1, ckpt_every=2)
    return [mod.TrainerConfig(train=tsm.TrainConfig(loss_chunk=8), ckpt_dir=ckpt_dir, **kw)
            for mod, tsm in ((trainer, ts), (rtrainer, rts))]


def test_trainer_fit_matches_reference_and_checkpoints_cross_restore(smoke, tmp_path):
    """Three steps of ``Trainer.fit`` against the reference's, each writing
    checkpoints; then each package resumes from the other's checkpoint and
    takes a fourth step."""
    ref_cfg, ref_params, cfg, _ = smoke
    (tc, rc) = trainer_cfgs(str(tmp_path / "port"))
    rc.ckpt_dir = str(tmp_path / "ref")
    data = batches(cfg, 4, b=2)
    port = trainer.Trainer(cfg, tc, params=ref_params, device="cpu")
    ref = rtrainer.Trainer(ref_cfg, rc, rng=jax.random.key(0))
    tres, rres = port.fit(data[:3]), ref.fit(data[:3])
    port.close()
    assert tres["final_step"] == rres["final_step"] == 3
    for th, rh in zip(tres["history"], rres["history"]):
        assert th["step"] == rh["step"]
        np.testing.assert_allclose(th["loss"], rh["loss"], rtol=STEP_TOL["loss"])
    assert_state_close(port.params, port.opt_state.m, port.opt_state.v,
                       ref.params, ref.opt_state.m, ref.opt_state.v)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())

    # the reference's checkpoint restores in the port, and the port's in
    # the reference, each bitwise equal to what its writer held
    (tc2, rc2) = trainer_cfgs(str(tmp_path / "ref"))
    rc2.ckpt_dir = str(tmp_path / "port")
    port2 = trainer.Trainer(cfg, tc2, params=ref_params, device="cpu")
    ref2 = rtrainer.Trainer(ref_cfg, rc2, rng=jax.random.key(1))
    assert port2.try_resume() and ref2.try_resume()
    assert port2.step == ref2.step == 3
    assert isinstance(port2.opt_state, opt.AdamWState)
    assert port2.opt_state.step.dtype == torch.int32 and int(port2.opt_state.step) == 3
    for reader, writer in (
            (tree_flatten(port2.state())[0],
             jax.tree_util.tree_leaves({"opt": ref.opt_state, "params": ref.params,
                                        "step": ref.step})),
            (jax.tree_util.tree_leaves({"opt": ref2.opt_state, "params": ref2.params,
                                        "step": ref2.step}),
             tree_flatten(port.state())[0])):
        assert len(reader) == len(writer)
        for a, b in zip(reader, writer):
            a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
            b = to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b)
            np.testing.assert_array_equal(a, b)
    port2.tcfg.total_steps = 4
    assert port2.fit(data[3:])["final_step"] == 4
    port2.close()


# ---------------------------------------------------------------- checkpoint


def train_state(params_np):
    """The same Trainer state tree in both packages: {params, opt, step}."""
    rstate = {"params": params_np, "opt": ropt.init_state(params_np), "step": 7}
    rstate["opt"] = rstate["opt"]._replace(
        step=jnp.asarray(5, jnp.int32),
        m=jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, params_np))
    tp = tree_map(torch.from_numpy, params_np)
    tstate = {"params": tp, "opt": opt.AdamWState(
        step=torch.tensor(5, dtype=torch.int32),
        m=tree_map(lambda a: torch.from_numpy(np.asarray(a) * 0.5), params_np),
        v=tree_map(torch.zeros_like, tp)), "step": 7}
    return tstate, rstate


def test_checkpoint_npy_files_and_store_images_are_byte_identical(smoke, tmp_path):
    _, ref_params, _, _ = smoke
    tstate, rstate = train_state(ref_params)
    ckpt.save(tmp_path / "port", 7, tstate)
    rckpt.save(tmp_path / "ref", 7, rstate)
    port_dir, ref_dir = tmp_path / "port" / "step_000000007", tmp_path / "ref" / "step_000000007"
    files = sorted(p.name for p in ref_dir.glob("leaf_*.npy"))
    assert files == sorted(p.name for p in port_dir.glob("leaf_*.npy"))
    assert len(files) == len(jax.tree_util.tree_leaves(rstate))
    for name in files:
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
    tm, rm = (json.loads((d / "manifest.json").read_text()) for d in (port_dir, ref_dir))
    assert tm["leaves"] == rm["leaves"] and tm["step"] == rm["step"]
    # the opt step leaf is int32, the top-level step int64, in both
    dtypes = [m["dtype"] for m in rm["leaves"]]
    assert dtypes.count("int32") == 1 and dtypes[-1] == "int64"

    import repro.core as RC
    nbytes = sum(np.asarray(a).nbytes for a in jax.tree_util.tree_leaves(rstate))
    tstore, rstore = HostArrayStore(np.zeros(nbytes + 64, np.uint8)), \
        RC.HostArrayStore(np.zeros(nbytes + 64, np.uint8))
    tman = ckpt.save_tree_to_store(tstore, tstate, offset=64)
    rman = rckpt.save_tree_to_store(rstore, rstate, offset=64)
    assert tman["leaves"] == rman["leaves"] and tman["nbytes"] == rman["nbytes"]
    buf = np.empty(nbytes + 64, np.uint8)
    rbuf = np.empty(nbytes + 64, np.uint8)
    tstore.read_into(0, buf)
    rstore.read_into(0, rbuf)
    np.testing.assert_array_equal(buf, rbuf)
    # each package restores the other's store image
    back = ckpt.restore_tree_from_store(tstore, rman, tstate)
    assert isinstance(back["opt"], opt.AdamWState)
    rback = rckpt.restore_tree_from_store(rstore, tman, rstate)
    for a, b in zip(tree_flatten(back)[0], jax.tree_util.tree_leaves(rback)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_async_save_copies_the_state_before_returning(tmp_path):
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    c = ckpt.AsyncCheckpointer(tmp_path, writers=1)
    c.save_async(1, {"w": w, "opt": opt.init_state({"w": w}), "step": 1})
    w.add_(100.0)                       # training mutates in place afterwards
    c.close()
    back = ckpt.restore(tmp_path, 1, {"w": w, "opt": opt.init_state({"w": w}), "step": 1})
    np.testing.assert_array_equal(back["w"], np.arange(12, dtype=np.float32).reshape(3, 4))
    assert ckpt.latest_step(tmp_path) == 1 and int(back["step"]) == 1


# ------------------------------------------------------------------ launcher


def test_launcher_trains_three_finite_steps_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-135m", "--smoke",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    losses = [float(ln.split()[3]) for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses), out.stdout


def test_launcher_refuses_the_distribution_options(tmp_path, monkeypatch):
    """The distribution options are refused no more: ``--dry`` runs the
    meta-device dry run of ``train_4k`` on the production mesh ``--mesh``
    names and writes its record under ``build/dryrun/``."""
    from repro_torch.launch.train import main
    monkeypatch.chdir(tmp_path)
    assert main(["--arch", "llama3-8b", "--dry", "--mesh", "single"]) == 0
    rec = json.loads((tmp_path / "build/dryrun/llama3-8b__train_4k__pod16x16.json").read_text())
    assert rec["ok"] and rec["devices"] == 256 and rec["kind"] == "train"
    assert main(["--arch", "smollm-135m", "--dry", "--mesh", "multi"]) == 0
    assert (tmp_path / "build/dryrun/smollm-135m__train_4k__pod2x16x16.json").is_file()


def test_train_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.launch.train import main
    from repro_torch.train.ooc import OOCTrainer, OOCTrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.Trainer(cfg, trainer.TrainerConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        OOCTrainer(cfg, ts.TrainConfig(), OOCTrainerConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])

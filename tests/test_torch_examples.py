"""PyTorch port: the example scripts (``repro_torch.examples``) beside the
JAX package's, on the CPU.

* ``serve_paged``'s body on the smollm smoke config (fp32, the JAX
  package's weights carried across), 3 requests of 4 new tokens: every
  request's tokens equal those of the JAX package's ``ServeEngine`` fed the
  same requests, and the example's own cross-check against unbatched
  contiguous decode holds.
* ``train_smollm``'s body at the smoke config, 3 steps on the example's
  token shard streamed through a UMap region: the losses within rtol 1e-5
  (fp32) of the JAX package's ``Trainer`` on the same shard; then a fourth
  step resumed from the example's checkpoint.
* ``out_of_core_sort`` at 8 MiB: every run descending, the file a
  permutation of ``_make_dataset``'s values and equal to what the JAX
  package's ``benchmarks/bench_sort.py`` sort leaves, the merge's values
  all of them.
* ``quickstart`` ends with ``quickstart OK``.
* The examples import neither ``jax`` nor ``repro`` nor ``benchmarks``, and
  the two that use the card refuse to run without one unless asked for the
  CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models as RM
import repro.serve.engine as jax_engine
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.examples import out_of_core_sort, quickstart, serve_paged, train_smollm
from repro_torch.interop import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5                      # fp32, tests/test_torch_train.py STEP_TOL["loss"]
SERVE_REQUESTS, SERVE_NEW, PAGE = 3, 4, 8
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 4, 32
SORT_MB, SORT_BUFFER_MB = 8, 2


@pytest.fixture(scope="module")
def smoke():
    """(JAX config, JAX params, port config, the same params as numpy)."""
    ref_cfg = ref_smoke_config("smollm-135m")
    ref_params = RM.init_params(ref_cfg, jax.random.key(0))
    return (ref_cfg, ref_params, get_smoke_config("smollm-135m"),
            jax.tree_util.tree_map(np.asarray, ref_params))


def test_serve_paged_matches_the_jax_engine(smoke, monkeypatch):
    ref_cfg, ref_params, cfg, np_params = smoke
    params = params_from_numpy(np_params, device="cpu", cfg=cfg)
    eng, _ = serve_paged.serve(cfg, params, serve_paged.requests(cfg, SERVE_REQUESTS, SERVE_NEW),
                               PAGE, "cpu")
    got = {r.rid: list(r.generated) for r in eng.finished}

    # the JAX engine calls prefill eagerly; jitted, each bucket compiles once
    monkeypatch.setattr(jax_engine.T, "prefill", jax.jit(RM.prefill, static_argnums=0))
    ecfg = serve_paged.engine_config(PAGE)
    ref = jax_engine.ServeEngine(ref_cfg, ref_params, jax_engine.EngineConfig(
        **{k: getattr(ecfg, k) for k in ("max_batch", "page_size", "num_pages",
                                         "max_pages_per_seq", "prefill_bucket",
                                         "admit_high_water", "admit_low_water")}))
    for r in serve_paged.requests(cfg, SERVE_REQUESTS, SERVE_NEW):
        ref.submit(jax_engine.Request(rid=r.rid, prompt=r.prompt,
                                      max_new_tokens=r.max_new_tokens, deadline_s=r.deadline_s))
    ref.run_until_drained(max_steps=2000)
    want = {r.rid: list(r.generated) for r in ref.finished}

    assert len(got) == SERVE_REQUESTS and all(len(t) == SERVE_NEW for t in got.values())
    assert got == want
    req = eng.finished[0]
    assert serve_paged.contiguous_decode(cfg, eng.params, req.prompt, SERVE_NEW,
                                         "cpu") == req.generated


def test_train_smollm_matches_the_jax_trainer_and_resumes(smoke, tmp_path):
    from repro.core import FileStore as RFileStore
    from repro.core import UMapConfig as RUMapConfig
    from repro.data.pipeline import lm_batches as ref_lm_batches
    from repro.train.optimizer import AdamWConfig as RAdamWConfig
    from repro.train.train_step import TrainConfig as RTrainConfig
    from repro.train.trainer import Trainer as RTrainer
    from repro.train.trainer import TrainerConfig as RTrainerConfig

    ref_cfg, _, cfg, np_params = smoke
    shard = tmp_path / "tokens.bin"
    train_smollm.write_shard(shard, TRAIN_STEPS + 1, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    ckpt = str(tmp_path / "ckpt")
    got = train_smollm.train(cfg, shard, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, ckpt, "cpu",
                             params=np_params)

    tc = train_smollm.trainer_config(TRAIN_STEPS, TRAIN_SEQ, None)
    ref = RTrainer(ref_cfg, RTrainerConfig(
        train=RTrainConfig(optimizer=RAdamWConfig(learning_rate=3e-4, warmup_steps=20,
                                                  total_steps=TRAIN_STEPS),
                           loss_chunk=TRAIN_SEQ),
        total_steps=TRAIN_STEPS, ckpt_every=tc.ckpt_every, log_every=tc.log_every),
        rng=jax.random.key(0))
    loader, reader = ref_lm_batches(RFileStore(str(shard)), TRAIN_BATCH, TRAIN_SEQ,
                                    config=RUMapConfig(page_size=256 * 1024, buffer_size=4 << 20,
                                                       num_fillers=2, num_evictors=1,
                                                       read_ahead=4, eviction_policy="swa"))
    try:
        want = ref.fit(loader)
    finally:
        reader.close()

    assert not got["resumed"] and got["final_step"] == want["final_step"] == TRAIN_STEPS
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], rtol=LOSS_RTOL)
    assert got["pipeline"]["demand_faults"] > 0

    # the example's restart: a longer run picks up from its checkpoint
    more = train_smollm.train(cfg, shard, TRAIN_STEPS + 1, TRAIN_BATCH, TRAIN_SEQ, ckpt, "cpu",
                              params=np_params)
    assert more["resumed"] and more["resumed_step"] == TRAIN_STEPS
    assert more["final_step"] == TRAIN_STEPS + 1
    assert np.isfinite(more["history"][-1]["loss"])


def test_out_of_core_sort_sorts_every_run_and_merges_every_value(tmp_path):
    from benchmarks.bench_sort import _make_dataset as ref_dataset
    from benchmarks.bench_sort import _sort_through_region as ref_sort
    from repro.core import UMapConfig as RUMapConfig

    n_bytes, buffer = SORT_MB << 20, SORT_BUFFER_MB << 20
    n, run = n_bytes // 8, buffer // 2 // 8
    src = tmp_path / "data.bin"
    res = out_of_core_sort.run(src, n_bytes, buffer)
    assert list(res) == list(out_of_core_sort.configs(buffer))
    for r in res.values():
        assert r["merged_bytes"] == n_bytes
        assert r["merged_sum"] == n * (n - 1) // 2
    got = np.fromfile(src, np.int64)
    runs = got.reshape(-1, run)
    assert runs.shape[0] == n_bytes // (buffer // 2) > 1
    assert (np.diff(runs, axis=1) <= 0).all()
    np.testing.assert_array_equal(np.sort(got), np.arange(n))

    # the JAX package's sort of the same dataset leaves the same file
    ref_src = tmp_path / "ref.bin"
    ref_dataset(ref_src, n_bytes)
    cfg = out_of_core_sort.configs(buffer)["umap (1M pages, 8 fillers)"]
    ref_sort(ref_src, RUMapConfig(page_size=cfg.page_size, buffer_size=cfg.buffer_size,
                                  num_fillers=cfg.num_fillers, num_evictors=cfg.num_evictors,
                                  read_ahead=cfg.read_ahead), n_bytes)
    np.testing.assert_array_equal(np.fromfile(ref_src, np.int64), got)


def test_quickstart_ends_ok(capsys):
    assert quickstart.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "quickstart OK"
    assert any(ln.startswith("advised page size") for ln in lines)


_GUARD = r"""
import importlib, json, sys
for name in ("quickstart", "out_of_core_sort", "serve_paged", "train_smollm"):
    importlib.import_module("repro_torch.examples." + name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "repro", "benchmarks"))
print(json.dumps(bad))
"""


def test_examples_import_no_jax_repro_or_benchmarks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env, check=True, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("example,argv", [(serve_paged, []),
                                          (train_smollm, ["--steps", "1"])])
def test_card_examples_default_to_cuda_and_raise_without_it(example, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        example.main(argv)

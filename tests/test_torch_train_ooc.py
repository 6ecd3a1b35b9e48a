"""PyTorch port: out-of-core training against the JAX package, on the CPU.

``repro_torch/train/{paged_state,ooc}.py``, with the tiny model of
``tests/test_train_ooc.py`` (2 layers, d 64) and the reference's weights
through ``params=``:

* ``pack_tree`` images and specs byte for byte the reference's;
  ``interleave_moments`` / ``split_moments`` equal to the reference's;
* within the port, bitwise: ``OOCTrainer`` paged against resident at two
  page sizes x two oversubscriptions and at a one-page sweep chunk, with
  no staging copy; at 4 and 8 KiB pages x 4 with 16 metadata stripes,
  where lease runs put more pages on a stripe than it owns and the
  reference's own ``TestDifferential`` never finishes (the sweep's chunks
  are now cut to fit); a run through transient ``ChaosStore`` faults
  against one without, and one whose faults reach the step's retry (one-page
  sweep chunks, no read-ahead);
* a hard outage of the moments store: the step raises ``OSError``, and after
  the revive replays bitwise (ROADMAP.md, Queue 3 item 4: a write-back that
  failed late left a stripe of quarantined pages that no fill could evict;
  the paging core now fails such a fill instead of waiting forever);
* the port's paged ``OOCTrainer`` against the reference's paged one over
  three steps: losses rtol 1e-5, parameters atol 5e-5 + rtol 1e-5, m and v
  within 1e-4 of their norm (the tolerances of ``test_torch_train.py``);
* checkpoints: the reference's ``OOCTrainer`` checkpoint restores in the
  port and the port's in the reference, bitwise, through the ``.npy`` and
  the store path; telemetry registers the train collector.
"""

import threading

import jax
import numpy as np
import pytest

import repro.core as RC
import repro.models as RM
import repro.train.ooc as rooc
import repro.train.paged_state as rps
import repro.train.train_step as rts
import repro_torch.core as TC
import repro_torch.train.paged_state as ps
from repro.configs.base import ModelConfig as RefModelConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import tree_flatten
from repro_torch.train.ooc import OOCTrainer, OOCTrainerConfig
from repro_torch.train.train_step import TrainConfig

PAGE = 4096
B, S = 2, 16
STEPS = 3
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's tiny-model weights (key 1, as its OOC tests), numpy."""
    return jax.tree_util.tree_map(np.asarray, RM.init_params(RefModelConfig(**TINY),
                                                             jax.random.key(1)))


def batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (B, S), dtype=np.int64).astype(np.int32),
             "labels": rng.integers(0, 256, (B, S), dtype=np.int64).astype(np.int32)}
            for _ in range(n)]


def paged_kw(params, page_size, oversub):
    """Buffer sizing for ~``oversub``x state oversubscription (the
    reference's ``_paged_kw``)."""
    _, specs, _ = ps.pack_tree(params, page_size)
    mv = jax.tree_util.tree_map(lambda p: np.zeros(2 * p.size, np.float32), params)
    _, mv_specs, _ = ps.pack_tree(mv, page_size)
    pt, mt = sum(s["npages"] for s in specs), sum(s["npages"] for s in mv_specs)
    largest = max(s["npages"] for s in specs)
    p_slots = max(2 * largest, pt // oversub)
    return dict(params_buffer_pages=p_slots,
                moments_buffer_pages=max(8, (pt + mt) // oversub - p_slots))


def make(params, paged, page_size=PAGE, ocfg_kw=None, model=None, **kw):
    return OOCTrainer(ModelConfig(**(model or TINY)), TrainConfig(),
                      OOCTrainerConfig(page_size=page_size, **(ocfg_kw or {})),
                      paged=paged, params=params, device="cpu", **kw)


def within(fn, seconds=120):
    """``fn()`` on a daemon thread: its result, or its exception, or a test
    failure after ``seconds``.  The paging core can wait forever on a lease
    run it cannot grant (ROADMAP.md, Queue 3 item 3); a hang then fails this
    test instead of stopping the whole run."""
    out = {}

    def target():
        try:
            out["result"] = fn()
        except BaseException as exc:   # handed to the test's thread below
            out["error"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"no progress in {seconds} s: a lease run the paging core "
                    "cannot grant (ROADMAP.md, Queue 3 item 3)")
    if "error" in out:
        raise out["error"]
    return out["result"]


def steps(tr, bs=None):
    return within(lambda: [tr.step(b)["loss"] for b in (bs or batches())])


def run(tr, bs=None):
    try:
        losses = steps(tr, bs)
        return tr.state_dict(), losses
    finally:
        tr.close()


def assert_state_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def resident(ref_params):
    """(state_dict, losses) of the port's resident trainer — the oracle."""
    return run(make(ref_params, paged=False))


# --------------------------------------------------------------- layouts


@pytest.mark.parametrize("page_size", [PAGE, 3 * PAGE])
def test_pack_tree_is_byte_identical_to_reference(ref_params, page_size):
    buf, specs, treedef = ps.pack_tree(ref_params, page_size)
    rbuf, rspecs, _ = rps.pack_tree(ref_params, page_size)
    assert specs == rspecs
    np.testing.assert_array_equal(buf, rbuf)
    mixed = {"b": np.arange(5, dtype=np.int32), "a": [np.ones((3, 3), np.float32)]}
    got, want = ps.pack_tree(mixed, 8), rps.pack_tree(mixed, 8)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


def test_interleave_and_split_moments_match_reference(ref_params):
    rng = np.random.default_rng(2)
    m = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                               ref_params)
    v = jax.tree_util.tree_map(lambda p: rng.random(p.shape).astype(np.float32), ref_params)
    got, want = ps.interleave_moments(m, v), rps.interleave_moments(m, v)
    assert_state_equal(got, want)
    for flat, p in zip(tree_flatten(got)[0], tree_flatten(ref_params)[0]):
        for a, b in zip(ps.split_moments(flat, p.shape), rps.split_moments(flat, p.shape)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- differential


@pytest.mark.parametrize("page_size,oversub", [
    (PAGE // 2, 2), (PAGE // 2, 3), (PAGE, 2), (PAGE, 3)])
def test_paged_is_bitwise_resident(ref_params, resident, page_size, oversub):
    ref_state, ref_losses = resident
    tr = make(ref_params, paged=True, page_size=page_size,
              ocfg_kw=paged_kw(ref_params, page_size, oversub))
    assert tr.oversubscription() >= oversub * 0.95
    try:
        losses = steps(tr)
        assert losses == ref_losses
        assert_state_equal(tr.state_dict(), ref_state)
        # every lease on the training path was a direct page-buffer view
        assert tr.staging_copies == 0
        assert tr.stats["sweep_chunks"] > 0 and tr.stats["last_sweep_s"] > 0
    finally:
        tr.close()


@pytest.mark.parametrize("page_size", [PAGE, 2 * PAGE])
def test_paged_is_bitwise_resident_where_runs_overflow_a_stripe(ref_params, resident,
                                                                monkeypatch, page_size):
    """The reference's TestDifferential geometries that never finish on an
    8-thread host (4x oversubscription, 4 and 8 KiB pages).  The paging
    core keeps a free-slot list per metadata stripe (page p on stripe
    hash((region, p)) % stripes); a lease run with more pages on one stripe
    than the stripe owns slots was never granted, and lease_run retried it
    forever.  With 8 hardware threads (16 stripes, whatever this host has)
    the planned sweep chunks and snapshot runs are now cut to fit."""
    monkeypatch.setattr(TC.config.os, "cpu_count", lambda: 8)
    ref_state, ref_losses = resident
    tr = make(ref_params, paged=True, page_size=page_size,
              ocfg_kw=paged_kw(ref_params, page_size, 4))
    assert tr.oversubscription() >= 4 * 0.95
    try:
        assert len(tr.opt.mv.region.service.shards) == min(
            16, tr.opt.mv.region.service.buffer.num_slots // 4)
        # some chunk was cut short of chunk_pages before its leaf's end
        assert any(n < tr.chunk_pages and lo + n < spec["npages"]
                   for chunks, spec in zip(tr._chunks, tr._p_specs) for lo, n in chunks)
        losses = steps(tr)
        assert losses == ref_losses
        assert_state_equal(within(tr.state_dict), ref_state)
        assert tr.staging_copies == 0
    finally:
        tr.close()


def test_one_page_sweep_chunks_are_bitwise_resident(ref_params, resident):
    ref_state, ref_losses = resident
    state, losses = run(make(ref_params, paged=True,
                             ocfg_kw=dict(paged_kw(ref_params, PAGE, 2), sweep_chunk_pages=1)))
    assert losses == ref_losses
    assert_state_equal(state, ref_state)


def chaos_factory(seed, out):
    def factory(buf):
        out.append(TC.ChaosStore(TC.HostArrayStore(buf), seed=seed))
        return out[0]
    return factory


def test_transient_faults_complete_bitwise(ref_params, resident):
    """Injected read and write faults on the moments store: the run
    completes bitwise equal to one without faults.  Whether a fault
    surfaces as a step retry depends on which fill it hits (one the pager
    posted ahead and then refills on demand does not; ROADMAP.md, Queue 3
    item 4)."""
    ref_state, ref_losses = resident
    chaos = []
    tr = make(ref_params, paged=True,
              ocfg_kw=dict(paged_kw(ref_params, PAGE, 2), max_step_retries=8),
              moments_store_factory=chaos_factory(5, chaos))
    def run_with_faults():
        losses = []
        for i, b in enumerate(batches()):
            if i == 1:
                chaos[0].fail_next("read", 3)
                chaos[0].fail_next("write", 2)
            losses.append(tr.step(b)["loss"])
        return losses

    try:
        losses = within(run_with_faults)
        assert chaos[0].injected_read_errors == 3
        assert tr.stats["io_errors"] == tr.stats["step_retries"]
        assert losses == ref_losses
        tr.drain_quarantine()
        assert_state_equal(tr.state_dict(), ref_state)
    finally:
        tr.close()


def test_transient_faults_reach_the_step_retry(ref_params, resident):
    """The same faults where the demand reads take them: one-page sweep
    chunks and no read-ahead on the moments, so each chunk's lease run
    posts only the two moment pages it waits on and a failed fill raises
    in the sweep.  The step retries from its stash and ends bitwise equal
    to the run without faults (the reference's
    ``TestChaosTraining::test_transient_faults_retry_bitwise``)."""
    ref_state, ref_losses = resident
    chaos = []
    tr = make(ref_params, paged=True,
              ocfg_kw=dict(paged_kw(ref_params, PAGE, 2), max_step_retries=8,
                           sweep_chunk_pages=1, advise_moments=False),
              moments_store_factory=chaos_factory(5, chaos))

    def run_with_faults():
        losses = []
        for i, b in enumerate(batches()):
            if i == 1:
                chaos[0].fail_next("read", 3)
                chaos[0].fail_next("write", 2)
            losses.append(tr.step(b)["loss"])
        return losses

    try:
        losses = within(run_with_faults)
        assert chaos[0].injected_read_errors == 3
        assert losses == ref_losses
        assert tr.stats["io_errors"] > 0
        assert tr.stats["step_retries"] > 0
        tr.drain_quarantine()
        assert_state_equal(tr.state_dict(), ref_state)
    finally:
        tr.close()


def test_outage_surfaces_oserror_then_resumes(ref_params, resident):
    """A hard outage of the moments store: the step raises ``OSError``
    (never silently corrupts), and after the revive the same step replays
    bitwise from the stashed grads and the chunk done-set (the reference's
    ``TestChaosTraining::test_outage_surfaces_oserror_then_resumes``)."""
    ref_state, ref_losses = resident
    chaos = []
    tr = make(ref_params, paged=True,
              ocfg_kw=dict(paged_kw(ref_params, PAGE, 2), max_step_retries=2),
              moments_store_factory=chaos_factory(7, chaos))

    def outage():
        bs = batches()
        losses = [tr.step(bs[0])["loss"]]
        chaos[0].kill()
        with pytest.raises(OSError):
            tr.step(bs[1])
        assert tr.stats["io_errors"] > 0
        assert tr.step_no == 1          # the failed step did not count
        chaos[0].revive()
        tr.drain_quarantine()
        losses.append(tr.step(bs[1])["loss"])
        losses.append(tr.step(bs[2])["loss"])
        return losses

    try:
        assert within(outage) == ref_losses
        assert_state_equal(tr.state_dict(), ref_state)
    finally:
        tr.close()


# ---------------------------------------------------------- vs reference


def test_paged_matches_reference_paged_trainer(ref_params):
    """In fp32 compute, the tolerances' dtype (the tiny config computes in
    bf16 by default, where XLA's and PyTorch's matmuls round apart)."""
    kw = paged_kw(ref_params, PAGE, 2)
    fp32 = dict(TINY, compute_dtype="float32")
    state, losses = run(make(ref_params, paged=True, ocfg_kw=kw, model=fp32))
    ref = rooc.OOCTrainer(RefModelConfig(**fp32), rts.TrainConfig(),
                          rooc.OOCTrainerConfig(page_size=PAGE, **kw),
                          rng=jax.random.key(1), paged=True)
    try:
        ref_losses = within(lambda: [float(ref.step(b)["loss"]) for b in batches()])
        ref_state = ref.state_dict()
    finally:
        ref.close()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for g, r in zip(tree_flatten(state["params"])[0],
                    jax.tree_util.tree_leaves(ref_state["params"])):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=1e-5)
    for key in ("m", "v"):
        for g, r in zip(tree_flatten(state["opt"][key])[0],
                        jax.tree_util.tree_leaves(ref_state["opt"][key])):
            assert np.linalg.norm(g - r) <= 1e-4 * max(np.linalg.norm(r), 1e-30)
    assert state["step"] == ref_state["step"] == STEPS


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_restore_across_packages(ref_params, tmp_path, writer):
    """A paged trainer of one package saves after two steps; a trainer of
    the other package resumes from it bitwise and takes the third step."""
    kw = dict(paged_kw(ref_params, PAGE, 2), ckpt_dir=str(tmp_path))
    bs = batches()

    def port():
        return make(ref_params, paged=True, ocfg_kw=kw)

    def ref():
        return rooc.OOCTrainer(RefModelConfig(**TINY), rts.TrainConfig(),
                               rooc.OOCTrainerConfig(page_size=PAGE, **kw),
                               rng=jax.random.key(1), paged=True)

    first, second = (ref, port) if writer == "reference" else (port, ref)
    a = first()
    try:
        within(lambda: [a.step(b) for b in bs[:2]])
        a.save_checkpoint()
        a.ckptr.flush()
        saved = a.state_dict()
    finally:
        a.close()
    b = second()
    try:
        assert b.try_resume() and b.step_no == 2
        assert_state_equal(b.state_dict(), saved)
        assert np.isfinite(float(within(lambda: b.step(bs[2]))["loss"])) and b.step_no == 3
    finally:
        b.close()


def test_store_checkpoint_path_and_telemetry(ref_params):
    """``ckpt_store``: the batched store image of the port's paged state
    equals the reference's save of the same state, and restores; the train
    collector reports the trainer's counters."""
    from repro.ckpt.checkpoint import save_tree_to_store as ref_save
    from repro_torch.ckpt.checkpoint import restore_tree_from_store
    from repro_torch.telemetry import TelemetryRegistry

    kw = paged_kw(ref_params, PAGE, 2)
    store = TC.HostArrayStore(np.zeros(1 << 22, np.uint8))
    tr = make(ref_params, paged=True, ocfg_kw=kw, ckpt_store=store)
    try:
        within(lambda: tr.step(batches(1)[0]))
        reg = TelemetryRegistry()
        tr.register_telemetry(reg, label="t")
        fams = {f.name: f for f in reg.collect()}
        assert fams["umap_train_steps_total"].samples[0][2] == 1
        assert fams["umap_train_staging_copies_total"].samples[0][2] == 0
        tr.save_checkpoint()
        tr.ckptr.flush()
        state = tr.state_dict()
        man = tr.ckptr.store_manifest
        back = restore_tree_from_store(store, man, state)
        assert_state_equal([back["params"], back["opt"]], [state["params"], state["opt"]])
        # a 0-d leaf goes through the store as shape (1,), in both packages
        assert back["step"].shape == (1,) and int(back["step"][0]) == state["step"] == 1
        rstore = RC.HostArrayStore(np.zeros(1 << 22, np.uint8))
        rman = ref_save(rstore, state, offset=man["offset"])
        assert rman["leaves"] == man["leaves"]
        lo, n = man["offset"], man["nbytes"]
        got, want = np.empty(n, np.uint8), np.empty(n, np.uint8)
        store.read_into(lo, got)
        rstore.read_into(lo, want)
        np.testing.assert_array_equal(got, want)
    finally:
        tr.close()

"""PyTorch port: the layer-weight pager against the JAX package, on the CPU.

``repro_torch/serve/weight_pager.py`` ports ``pack_layer_arrays``,
``RegionLayerSource`` (lease views -> device page pool through
``page_scatter``, layers assembled by ``page_gather``) and
``LayerWeightPager`` (filler threads, stealing, the adaptive classifier).
Held to the reference on the same numpy inputs:

* packed images and specs byte-identical;
* every layer a source returns bitwise equal to the reference's over the
  same packed store, with equal region ``leases`` and ``staging_copies``
  (0 on the lease path), through ``invalidate``, a pool smaller than the
  model and the copy-backed fallback;
* ``LayerWeightPager.run`` within fp32 2e-5 of the reference.  With one
  filler and an in-order sweep the schedule fixes ``fills`` (each layer
  once) and ``evictions`` (fills - num_slots), so those are held equal;
  ``hits`` / ``waits`` depend on thread timing and are not;
* the slice as a whole: a weight-paged prefill of the qwen2 smoke config
  through the port's ``block_apply`` within fp32 2e-5 of the JAX package's
  ``prefill`` on the same weights, and bitwise equal to the port's own
  resident ``prefill``.

``test_torch_cuda.py`` holds the card's path (H2D copies on filler streams,
the CUDA page copies) to this one.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.serve.weight_pager as rwp
import repro_torch.core as TC
import repro_torch.serve.weight_pager as wp
from repro_torch.interop import tree_flatten, tree_map, tree_unflatten

TOL = dict(atol=2e-5, rtol=2e-5)
PS = 512


def make_layers(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = [(16, 16), (5, 7), (300,), (16, 16), (33, 2), (16, 16)]
    return [rng.standard_normal(s).astype(np.float32).astype(dtype) for s in shapes]


def regions(buf, page_size=PS, **cfg):
    """The same packed image behind a reference region and a port region."""
    kw = dict(page_size=page_size, buffer_size=64 * page_size, num_fillers=2,
              num_evictors=1, **cfg)
    return (RC.umap(RC.HostArrayStore(buf.copy()), config=RC.UMapConfig(**kw)),
            TC.umap(TC.HostArrayStore(buf.copy()), config=TC.UMapConfig(**kw)))


def bits(x):
    a = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.bfloat16 else np.asarray(x)
    return a.view(np.uint8)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int32])
@pytest.mark.parametrize("page_size", [64, 512, 4096])
def test_pack_layer_arrays_matches_reference(dtype, page_size):
    layers = make_layers(1, dtype)
    buf, specs = wp.pack_layer_arrays(layers, page_size)
    rbuf, rspecs = rwp.pack_layer_arrays(layers, page_size)
    assert buf.dtype == rbuf.dtype and buf.tobytes() == rbuf.tobytes()
    assert specs == rspecs


def test_pack_layer_arrays_refusals_match_reference():
    for bad, ps in (([np.zeros(3, np.float32), np.zeros(3, np.int32)], 64),
                    ([np.zeros(3, np.float32)], 6)):
        for mod in (wp, rwp):
            with pytest.raises(ValueError):
                mod.pack_layer_arrays(bad, ps)


@pytest.mark.parametrize("zero_copy", [True, False])
@pytest.mark.parametrize("pool_pages", [None, 3])
def test_region_layer_source_bitwise_matches_reference(zero_copy, pool_pages):
    """Two sweeps with an invalidation between them; with 3 pool pages
    (the largest layer) every layer evicts the one before."""
    layers = make_layers()
    buf, specs = wp.pack_layer_arrays(layers, PS)
    rr, tr = regions(buf, zero_copy_leases=zero_copy)
    try:
        ref = rwp.RegionLayerSource(rr, specs, pool_pages=pool_pages)
        src = wp.RegionLayerSource(tr, specs, device="cpu", pool_pages=pool_pages)
        for sweep in range(2):
            for i in range(len(layers)):
                got, want = src[i], ref[i]
                assert tuple(got.shape) == want.shape and got.dtype == torch.float32
                assert bits(got).tobytes() == bits(want).tobytes(), (sweep, i)
            ref.invalidate([0, 3])
            src.invalidate([0, 3])
        assert tr.stats()["leases"] == rr.stats()["leases"]
        assert src.staging_copies == ref.staging_copies
        # every fetched page goes through a lease, or else through a staging copy
        fetched = tr.stats()["leases"] if zero_copy else src.staging_copies
        assert fetched > 0 and (src.staging_copies if zero_copy else tr.stats()["leases"]) == 0
        src.invalidate()
        assert src._fifo == [] and len(src._free) == src.pool_pages
    finally:
        RC.uunmap(rr)
        TC.uunmap(tr)


@pytest.mark.parametrize("packed", ["bfloat16", "uint16"])
def test_bf16_layers_through_a_bf16_pool(packed):
    """bf16 weights packed by ml_dtypes (spec dtype "bfloat16") or as their
    uint16 bit patterns (how the port hands bf16 to numpy) come back as a
    bf16 tensor with the reference's bits."""
    layers = make_layers(2, ml_dtypes.bfloat16)
    host = layers if packed == "bfloat16" else [a.view(np.uint16) for a in layers]
    buf, specs = wp.pack_layer_arrays(host, PS)
    rbuf, rspecs = rwp.pack_layer_arrays(layers, PS)
    assert buf.tobytes() == rbuf.tobytes()
    rr, tr = regions(buf)
    try:
        ref = rwp.RegionLayerSource(rr, rspecs, pool_pages=4)
        src = wp.RegionLayerSource(tr, specs, device="cpu", pool_pages=4,
                                   dtype=torch.bfloat16)
        for i in range(len(layers)):
            got = src[i]
            assert got.dtype == torch.bfloat16
            assert bits(got).tobytes() == bits(ref[i]).tobytes(), i
        assert src.staging_copies == 0
    finally:
        RC.uunmap(rr)
        TC.uunmap(tr)
    with pytest.raises(ValueError, match="item size"):
        wp.RegionLayerSource(tr, specs, device="cpu", dtype=torch.float32)


def test_region_layer_source_pin_fast_layers_on_a_tiered_store():
    """As ``tests/test_tiering.py``: the pinned layer's extents are promoted
    into the fast tier and pinned there, and the layer reads back."""
    page, extent = 4096, 4 * 4096
    layers = [np.full((extent // 4,), i, np.float32) for i in range(4)]
    buf, specs = wp.pack_layer_arrays(layers, page_size=page)
    ts = TC.TieredStore(TC.HostArrayStore(np.zeros(4 * extent, np.uint8)),
                        TC.HostArrayStore(buf.copy()), extent_size=extent,
                        promote_on_read=False)
    region = TC.umap(ts, config=TC.UMapConfig(page_size=page, buffer_size=32 * page))
    try:
        src = wp.RegionLayerSource(region, specs, device="cpu", pin_fast_layers=[0])
        spec = specs[0]
        want = list(range((spec["first_page"] * page) // extent,
                          ((spec["first_page"] + spec["npages"]) * page - 1) // extent + 1))
        assert set(want) <= set(ts.pinned_fast_extents())
        for _ in range(250):                       # promotion is asynchronous: <= 5 s
            if set(want) <= set(ts.resident_extents()):
                break
            threading.Event().wait(0.02)
        assert set(want) <= set(ts.resident_extents())
        np.testing.assert_array_equal(src[0].numpy(), layers[0])
    finally:
        TC.uunmap(region)


def test_region_layer_source_pin_fast_requires_a_tiered_store():
    buf, specs = wp.pack_layer_arrays([np.ones((PS // 4,), np.float32)], PS)
    region = TC.umap(TC.HostArrayStore(buf.copy()),
                     config=TC.UMapConfig(page_size=PS, buffer_size=8 * PS))
    try:
        with pytest.raises(ValueError, match="TieredStore"):
            wp.RegionLayerSource(region, specs, device="cpu", pin_fast_layers=[0])
        with pytest.raises(ValueError, match="largest"):
            wp.RegionLayerSource(region, specs, device="cpu", pool_pages=0)
    finally:
        TC.uunmap(region)


def test_region_layer_source_defaults_to_the_card(monkeypatch):
    buf, specs = wp.pack_layer_arrays([np.ones((PS // 4,), np.float32)], PS)
    region = TC.umap(TC.HostArrayStore(buf.copy()),
                     config=TC.UMapConfig(page_size=PS, buffer_size=8 * PS))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            wp.RegionLayerSource(region, specs)
        with pytest.raises(RuntimeError, match="cuda"):
            wp.LayerWeightPager([{"w": np.ones(2)}])
    finally:
        TC.uunmap(region)


def test_shared_source_under_thread_churn_returns_whole_layers():
    """8 threads read random layers of one source whose pool holds one layer,
    with a short switch interval: every layer comes back whole (a torn or
    lost install would show as foreign bytes), and every thread ends."""
    layers = make_layers(3)
    buf, specs = wp.pack_layer_arrays(layers, PS)
    region = TC.umap(TC.HostArrayStore(buf.copy()),
                     config=TC.UMapConfig(page_size=PS, buffer_size=64 * PS, num_fillers=2))
    src = wp.RegionLayerSource(region, specs, device="cpu", pool_pages=3)
    bad = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, len(layers), size=40):
            if not np.array_equal(src[int(i)].numpy(), layers[i]):
                bad.append(int(i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        TC.uunmap(region)
    assert bad == []


# ------------------------------------------------------------ LayerWeightPager


def tree_layers(seed=4, n=7):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((8, 8)).astype(np.float32) / 3,
             "b": {"bias": rng.standard_normal(8).astype(np.float32)}} for _ in range(n)]


def torch_apply(p, x, i):
    return torch.tanh(x @ p["w"] + p["b"]["bias"])


def jax_apply(p, x, i):
    return jnp.tanh(x @ jnp.asarray(p["w"]) + jnp.asarray(p["b"]["bias"]))


@pytest.mark.parametrize("num_slots,readahead", [(3, 2), (2, 1), (4, 0), (8, 3)])
def test_pager_run_matches_reference(num_slots, readahead):
    layers = tree_layers()
    x = np.random.default_rng(5).standard_normal((3, 8)).astype(np.float32)
    pager = wp.LayerWeightPager(layers, num_slots=num_slots, readahead=readahead, device="cpu")
    ref = rwp.LayerWeightPager(layers, num_slots=num_slots, readahead=readahead)
    try:
        got = pager.run(torch.from_numpy(x), torch_apply)
        want = ref.run(jnp.asarray(x), jax_apply)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in ("fills", "evictions", "steals", "pattern_transitions"):
            assert pager.stats[key] == ref.stats[key], key
        assert pager.stats["fills"] == len(layers)
        assert pager.stats["hits"] + pager.stats["waits"] == len(layers)
    finally:
        pager.close()
        ref.close()
    assert not any(t.is_alive() for t in pager._fillers)


def test_pager_with_fillers_stealing_matches_reference():
    """Four fillers and a burst of far-apart prefetches: the output is
    still the reference's, and every requested layer resolves."""
    layers = tree_layers(6, n=12)
    x = np.random.default_rng(7).standard_normal((2, 8)).astype(np.float32)
    pager = wp.LayerWeightPager(layers, num_slots=12, readahead=3, device="cpu",
                                num_fillers=4)
    ref = rwp.LayerWeightPager(layers, num_slots=12, readahead=3, num_fillers=4)
    try:
        for i in (0, 4, 8, 1, 5, 9):
            pager.prefetch(i)
        got = pager.run(torch.from_numpy(x), torch_apply)
        want = ref.run(jnp.asarray(x), jax_apply)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert pager.stats["fills"] == len(layers) and pager.stats["evictions"] == 0
    finally:
        pager.close()
        ref.close()


def test_adaptive_pager_retunes_as_the_reference():
    """The same get() schedule (a sweep, then random layers) makes the same
    classifier decisions: equal pattern_transitions and readahead."""
    layers = tree_layers(8, n=16)
    order = list(range(16)) + [int(i) for i in np.random.default_rng(9).integers(0, 16, 24)]
    pager = wp.LayerWeightPager(layers, num_slots=6, readahead=2, device="cpu", adaptive=True)
    ref = rwp.LayerWeightPager(layers, num_slots=6, readahead=2, adaptive=True)
    try:
        for i in order:
            np.testing.assert_array_equal(pager.get(i)["w"].numpy(), np.asarray(ref.get(i)["w"]))
            assert pager.readahead == ref.readahead
        assert pager.stats["pattern_transitions"] == ref.stats["pattern_transitions"] > 0
    finally:
        pager.close()
        ref.close()


def test_pager_over_a_region_source_matches_reference():
    layers = [a for a in make_layers(10) if a.shape == (16, 16)]
    buf, specs = wp.pack_layer_arrays(layers, PS)
    rr, tr = regions(buf)
    x = np.random.default_rng(11).standard_normal((4, 16)).astype(np.float32)
    try:
        src = wp.RegionLayerSource(tr, specs, device="cpu", pool_pages=2)
        rsrc = rwp.RegionLayerSource(rr, specs, pool_pages=2)
        pager = wp.LayerWeightPager(src, num_slots=2, readahead=1, device="cpu")
        ref = rwp.LayerWeightPager(rsrc, num_slots=2, readahead=1)
        try:
            got = pager.run(torch.from_numpy(x), lambda p, x, i: torch.tanh(x @ p))
            want = ref.run(jnp.asarray(x), lambda p, x, i: jnp.tanh(x @ p))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            assert pager.stats["fills"] == ref.stats["fills"] == len(layers)
            assert pager.stats["evictions"] == ref.stats["evictions"]
        finally:
            pager.close()
            ref.close()
        assert tr.stats()["leases"] == rr.stats()["leases"]
        assert src.staging_copies == 0
    finally:
        RC.uunmap(rr)
        TC.uunmap(tr)


def test_pager_reports_a_failed_fill_and_out_of_range_layers():
    class Broken(list):
        def __getitem__(self, i):
            raise OSError("backing store gone")

    pager = wp.LayerWeightPager(Broken([0, 1]), num_slots=2, readahead=1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="filler failed"):
            pager.get(0)
        with pytest.raises(IndexError):
            pager.get(2)
    finally:
        pager.close()


# ------------------------------------------------------- the slice as a whole


def layer_views(flat, treedef, shapes):
    """One flat layer back into its parameter tree, as views of ``flat``."""
    leaves, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        leaves.append(flat[off:off + n].view(shape))
        off += n
    return tree_unflatten(treedef, leaves)


def test_weight_paged_prefill_matches_the_jax_package():
    """qwen2's smoke config: its layers packed into a region, streamed
    through a pool of two layers by two fillers, each applied with the
    port's ``block_apply`` (prefill, default positions, no cache)."""
    import repro.models as RM
    import repro_torch.models.transformer as T
    from repro.configs.registry import get_smoke_config as ref_smoke_config
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.blocks import BlockCtx, block_apply
    from repro_torch.models.layers import rms_norm

    ref_cfg = ref_smoke_config("qwen2-1.5b")
    cfg = get_smoke_config("qwen2-1.5b")
    # seeded weights as numpy (the port's draw: padded heads' wo rows zero),
    # carried to the JAX package as arrays and to the port by params_from_numpy
    weights = tree_map(lambda t: t.numpy(), T.init_params(cfg, seed=0, device="cpu"))
    ref_params = jax.tree_util.tree_map(jnp.asarray, weights)
    params = params_from_numpy(weights, device="cpu", cfg=cfg)
    (seg,) = cfg.decoder_plan()
    stacked = params["segments"][0]
    per_layer = [tree_flatten(tree_map(lambda a, i=i: a[i], stacked)) for i in range(seg.count)]
    treedef = per_layer[0][1]
    shapes = [tuple(t.shape) for t in per_layer[0][0]]
    flats = [np.concatenate([t.numpy().reshape(-1) for t in leaves]) for leaves, _ in per_layer]
    page = 1024
    buf, specs = wp.pack_layer_arrays(flats, page)
    largest = max(s["npages"] for s in specs)
    region = TC.umap(TC.HostArrayStore(buf),
                     config=TC.UMapConfig(page_size=page, buffer_size=4 * largest * page,
                                          max_lease_run=largest))
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    try:
        src = wp.RegionLayerSource(region, specs, device="cpu", pool_pages=2 * largest)
        pager = wp.LayerWeightPager(src, num_slots=2, readahead=1, device="cpu", num_fillers=2)
        try:
            tok = torch.from_numpy(tokens)
            positions = torch.arange(tokens.shape[1], dtype=torch.int32).expand(*tokens.shape)
            ctx = BlockCtx(mode="prefill", positions=positions, default_positions=True)
            x = T.embed_tokens(cfg, params, tok)
            x = pager.run(x, lambda flat, x, i: block_apply(
                cfg, seg, layer_views(flat, treedef, shapes), x, ctx)[0])
            got = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, -1]
            assert pager.stats["fills"] == seg.count
        finally:
            pager.close()
        assert region.stats()["leases"] == sum(s["npages"] for s in specs)
        assert src.staging_copies == 0
    finally:
        TC.uunmap(region)
    want, _ = RM.prefill(ref_cfg, ref_params, {"tokens": jnp.asarray(tokens)},
                         [None] * len(ref_cfg.decoder_plan()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    resident, _ = T.prefill(cfg, params, {"tokens": tok}, [None])
    assert torch.equal(got, resident)

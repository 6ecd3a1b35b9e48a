"""PyTorch port: the layered page copies and their engine call sites against
the JAX package, on the CPU.

The port's ``page_gather`` / ``page_scatter`` take a layer axis (one launch
per pool on the card); their plain versions, which a CPU tensor runs, must
equal the JAX Pallas kernels run layer by layer in interpret mode, bit for
bit.  The engine's prefill install and copy-on-write must leave the same
pools as the reference's ``pool.at[:, idx].set(...)``, and make one copy
per pool whatever the depth.  ``test_torch_cuda.py`` holds the CUDA kernels
against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jax_engine
import repro_torch.serve.engine as torch_engine
from repro.kernels.page_gather.kernel import page_gather as jax_page_gather
from repro.kernels.page_gather.kernel import page_scatter as jax_page_scatter
from repro_torch.kernels.page_gather import kernel as copy_kernel
from repro_torch.kernels.page_gather import ops as gather_ops
from repro_torch.kernels.page_gather.ref import page_gather_ref, page_scatter_ref

TORCH_DTYPE = dict(float32=torch.float32, bfloat16=torch.bfloat16)


def to_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def both(a, dtype):
    """The same numbers for both packages: (jax array, torch tensor)."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TORCH_DTYPE[dtype])


# rows of a page: smollm's 16 x 3 x 64, and two that the bulk kernel cannot
# take (not a multiple of 16 bytes); tokens per page 16, 4 and 1
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("elems,tok", [(3072, 192), (1000, 250), (7, 7)])
@pytest.mark.parametrize("layers", [1, 3])
def test_layered_plain_copies_match_jax_per_layer(dtype, elems, tok, layers):
    rng = np.random.default_rng(elems + layers)
    p, n = 6, 3
    ids = rng.choice(p, size=n, replace=False).astype(np.int32)
    pool = rng.standard_normal((layers, p, elems)).astype(np.float32)
    pages = rng.standard_normal((layers, n, elems)).astype(np.float32)
    # a token-shaped source one token short of the n pages (a whole page
    # short at one token a page): zeros past it, as the reference pads
    s = n * elems // tok - 1
    src = rng.standard_normal((layers, s, tok)).astype(np.float32)
    padded = np.pad(src.reshape(layers, -1), ((0, 0), (0, n * elems - s * tok)))
    tpool, tpages, tsrc = (both(a, dtype)[1] for a in (pool, pages, src))
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)

    got = gather_ops.page_gather(tpool, tids)
    assert got.shape == (layers, n, elems)
    np.testing.assert_array_equal(to_f32(got), to_f32(page_gather_ref(tpool, tids)))
    scattered = gather_ops.page_scatter(tpool.clone(), tids, tpages)
    padded_in = gather_ops.page_scatter(tpool.clone(), tids, tsrc)
    # the JAX kernels one layer at a time (numpy slices: one compile a shape)
    for layer in range(layers):
        jpool = lambda: both(pool[layer], dtype)[0]          # noqa: E731 (scatter donates it)
        want = jax_page_gather(jpool(), jids, interpret=True)
        np.testing.assert_array_equal(to_f32(got[layer]), to_f32(want))
        want = jax_page_scatter(jpool(), jids, both(pages[layer], dtype)[0], interpret=True)
        np.testing.assert_array_equal(to_f32(scattered[layer]), to_f32(want))
        want = jax_page_scatter(jpool(), jids, both(padded[layer].reshape(n, elems), dtype)[0],
                                interpret=True)
        np.testing.assert_array_equal(to_f32(padded_in[layer]), to_f32(want))


def install_inputs(rng, dtype, layers, s, a0=4, kvh=2, d=8, ps=4, pages=16):
    """Pools full of numbers (so the zero tail shows), a prefill cache
    [L, 1, cap, KVH, D] and the pages receiving positions a0..a0+s."""
    pool_shape = (layers, pages, ps, kvh, d)
    k_pool, v_pool = (rng.standard_normal(pool_shape).astype(np.float32) for _ in range(2))
    cap = a0 + s + 8
    k, v = (rng.standard_normal((layers, 1, cap, kvh, d)).astype(np.float32) for _ in range(2))
    dest = [int(x) for x in rng.choice(pages, size=-(-s // ps) + 1, replace=False)]
    jcache = {"k_pool": both(k_pool, dtype)[0], "v_pool": both(v_pool, dtype)[0]}
    tcache = {"k_pool": both(k_pool, dtype)[1], "v_pool": both(v_pool, dtype)[1]}
    return jcache, tcache, both(k, dtype), both(v, dtype), dest


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 13, 16])       # one token, a short last page, whole pages
def test_install_pages_matches_reference(dtype, s):
    """The port's install reads the prefill cache in place (a strided view,
    as the engine hands it over) and pads the last page with zeros."""
    rng = np.random.default_rng(s)
    a0, ps = 4, 4
    jcache, tcache, (jk, tk), (jv, tv), dest = install_inputs(rng, dtype, 3, s, a0=a0, ps=ps)
    want = jax_engine._install_pages(jcache, jk[:, 0, a0:a0 + s], jv[:, 0, a0:a0 + s],
                                     dest, None, ps, len(dest))
    got = torch_engine._install_pages(tcache, tk[:, 0, a0:a0 + s], tv[:, 0, a0:a0 + s],
                                      dest, ps)
    for name in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(to_f32(got[name]), to_f32(want[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_on_write_matches_reference(dtype):
    rng = np.random.default_rng(3)
    jcache, tcache, *_ = install_inputs(rng, dtype, 3, 1)
    old, new = 5, 11
    got = torch_engine._copy_page(tcache, torch.tensor([old, new], dtype=torch.int32))
    for name in ("k_pool", "v_pool"):
        want = jcache[name].at[:, new].set(jcache[name][:, old])
        np.testing.assert_array_equal(to_f32(got[name]), to_f32(want))


class CountingCopies:
    """Counts the engine's copy calls, each still doing its work."""

    def __init__(self, monkeypatch):
        self.calls = {"page_gather": 0, "page_scatter": 0}
        for name in self.calls:
            monkeypatch.setattr(torch_engine, name, self._counted(name, getattr(torch_engine, name)))

    def _counted(self, name, fn):
        def call(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return call


@pytest.mark.parametrize("layers", [1, 3, 30])
def test_install_and_copy_on_write_make_one_copy_per_pool(monkeypatch, layers):
    counts = CountingCopies(monkeypatch)
    rng = np.random.default_rng(layers)
    _, tcache, (_, tk), (_, tv), dest = install_inputs(rng, "float32", layers, 13)
    torch_engine._install_pages(tcache, tk[:, 0, 4:17], tv[:, 0, 4:17], dest, 4)
    assert counts.calls == {"page_gather": 0, "page_scatter": 2}
    torch_engine._copy_page(tcache, torch.tensor([1, 2], dtype=torch.int32))
    assert counts.calls == {"page_gather": 2, "page_scatter": 4}


def test_engine_copies_at_most_two_per_install_and_copy_on_write(monkeypatch):
    """A served prefix request: every install (prefill or prefix) and every
    copy-on-write costs at most one scatter per pool, a copy-on-write one
    gather per pool."""
    import repro_torch.models as M
    from repro_torch.configs.registry import get_smoke_config

    counts = CountingCopies(monkeypatch)
    cfg = get_smoke_config("smollm-135m")
    eng = torch_engine.ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"),
                                   torch_engine.EngineConfig(max_batch=2, page_size=4,
                                                             num_pages=32, max_pages_per_seq=8,
                                                             prefill_bucket=8), device="cpu")
    prefix = np.arange(1, 11, dtype=np.int32)        # 10 tokens: not page-aligned
    eng.register_prefix(prefix)
    reqs = [torch_engine.Request(rid=0, prompt=prefix.copy(), max_new_tokens=3),
            torch_engine.Request(rid=1, prompt=np.arange(30, 37, dtype=np.int32),
                                 max_new_tokens=3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=50)
    assert all(r.done for r in reqs) and eng.stats["cow_copies"] >= 1
    installs = eng.stats["prefills"] + len(eng._prefixes)
    assert 0 < counts.calls["page_scatter"] <= 2 * (installs + eng.stats["cow_copies"])
    assert 0 < counts.calls["page_gather"] <= 2 * eng.stats["cow_copies"]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b"])
def test_engine_install_source_takes_the_bulk_variant(arch):
    """The prefill cache's K, sliced as the engine slices it, is a view the
    bulk kernel takes at the model's full width: rows, layer strides and the
    source run all multiples of 16 bytes (no copy is made for it)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    kvh, d, ps = cfg.num_kv_heads, cfg.head_dim, 16
    cache = torch.zeros((2, 1, 40, kvh, d), dtype=torch.bfloat16)
    src = gather_ops.token_rows(cache[:, 0, 4:25])        # a0 = 4, S = 21
    assert src.data_ptr() == cache[:, 0, 4].data_ptr()     # a view, not a copy
    pool = gather_ops.pool_rows(torch.zeros((2, 8, ps, kvh, d), dtype=torch.bfloat16))
    es = pool.element_size()
    row = pool.shape[2] * es
    assert copy_kernel.choose_variant(
        (src.data_ptr(), pool.data_ptr()), (src.stride(0) * es, pool.stride(0) * es),
        row, src.shape[1] * src.shape[2] * es) == "bulk"
    assert copy_kernel.choose_variant((2, 0), (), row, row) == "generic"      # base off 16
    assert copy_kernel.choose_variant((0, 0), (row + 2,), row, row) == "generic"
    assert copy_kernel.choose_variant((0, 0), (), 14, 14) == "generic"         # 7 bf16


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    from repro_torch import kernels as K

    before = (dict(K.launch_counts),
              {k: dict(v) for k, v in copy_kernel.copy_variant_counts.items()})
    pool = torch.arange(2 * 5 * 6, dtype=torch.float32).view(2, 5, 6)
    ids = torch.tensor([4, 0], dtype=torch.int32)
    assert torch.equal(gather_ops.page_gather(pool, ids), pool[:, [4, 0]])
    gather_ops.page_scatter(pool, ids, torch.ones((2, 3, 3)))
    assert torch.equal(pool[:, 4], torch.ones((2, 6)))
    assert torch.equal(pool[:, 0], torch.tensor([[1.0, 1, 1, 0, 0, 0]] * 2))
    after = (dict(K.launch_counts),
             {k: dict(v) for k, v in copy_kernel.copy_variant_counts.items()})
    assert after == before
    with pytest.raises(ValueError, match="one CUDA device"):
        copy_kernel.page_scatter(pool, ids, torch.ones((2, 3, 3)))


# the repaired contract for page ids outside [0, P): the JAX package's
# jnp.take (wrap [-P, 0), fill the rest) and .at[].set (wrap, drop the rest)
OUT_OF_RANGE_IDS = np.array([-1, -4, -5, 4, 7, 1, -(1 << 31), (1 << 31) - 1], np.int32)
OUT_OF_RANGE_DTYPES = {"float32": (jnp.float32, torch.float32),
                       "bfloat16": (jnp.bfloat16, torch.bfloat16),
                       "int32": (jnp.int32, torch.int32)}


def bits(x):
    """Raw bit patterns (NaN fills compare by their bits)."""
    a = np.asarray(x.view(torch.int16) if x.dtype == torch.bfloat16 else x) \
        if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype", list(OUT_OF_RANGE_DTYPES))
@pytest.mark.parametrize("layers", [None, 3])
def test_out_of_range_ids_match_jnp_take_and_at_set(dtype, layers):
    """P = 4: ids -1 and -4 wrap to pages 3 and 0, id 1 is page 1; the
    other ids read as jnp.take's fill (NaN, or the int32 minimum) and are
    dropped by a scatter.  Both the Pallas [P, E] contract and the layered
    pool, through ops (the plain versions for CPU tensors)."""
    jdt, tdt = OUT_OF_RANGE_DTYPES[dtype]
    rng = np.random.default_rng(9)
    n, P, E = len(OUT_OF_RANGE_IDS), 4, 6
    lead = () if layers is None else (layers,)
    pool = (rng.standard_normal(lead + (P, E)) * 100).astype(np.float32)
    pages = (rng.standard_normal(lead + (n, E)) * 100).astype(np.float32)
    # the scatter's pages for ids that land in the pool: one per page
    keep = np.array([0, 1, 5])                     # ids -1, -4, 1 -> pages 3, 0, 1
    tpool = torch.from_numpy(pool).to(tdt)
    tids = torch.from_numpy(OUT_OF_RANGE_IDS)
    got = gather_ops.page_gather(tpool, tids)
    scattered = gather_ops.page_scatter(tpool.clone(), tids, torch.from_numpy(pages).to(tdt))
    jids = jnp.asarray(OUT_OF_RANGE_IDS)
    for layer in ([None] if layers is None else range(layers)):
        pick = (lambda a: a) if layer is None else (lambda a, l=layer: a[l])  # noqa: E731
        jpool = jnp.asarray(pick(pool)).astype(jdt)
        want = jnp.take(jpool, jids, axis=0)
        np.testing.assert_array_equal(bits(pick(got)), bits(want))
        want = jpool.at[jids[keep]].set(jnp.asarray(pick(pages)[keep]).astype(jdt))
        np.testing.assert_array_equal(bits(pick(scattered)), bits(want))
    # the ids the scatter drops really are dropped by the reference too
    jpool = jnp.asarray(pool if layers is None else pool[0]).astype(jdt)
    jpages = jnp.asarray(pages if layers is None else pages[0]).astype(jdt)
    np.testing.assert_array_equal(bits(jpool.at[jids].set(jpages)),
                                  bits(jpool.at[jids[keep]].set(jpages[keep])))


def test_take_fill_is_jnp_takes_fill():
    """The plain version's fill value for every pool dtype the port uses,
    and the kernel's 16-byte fill pattern made from it, bit for bit against
    jnp.take's."""
    from repro_torch.kernels.page_gather.kernel import _pad_words
    from repro_torch.kernels.page_gather.ref import take_fill

    for jdt, tdt in [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                     (jnp.float16, torch.float16), (jnp.int32, torch.int32),
                     (jnp.int8, torch.int8), (jnp.uint8, torch.uint8),
                     (jnp.uint16, torch.uint16)]:
        want = np.asarray(jnp.take(jnp.zeros((1, 1), jdt), jnp.asarray([3]), axis=0))
        got = torch.full((1, 1), take_fill(tdt), dtype=tdt)
        assert got.view(torch.uint8).numpy().tobytes() == want.tobytes(), tdt
        lo, hi = _pad_words(tdt)
        pattern = lo.to_bytes(8, "little") + hi.to_bytes(8, "little")
        assert pattern == want.tobytes() * (16 // want.itemsize), tdt

"""PyTorch port: the paged KV cache driven op for op beside the JAX one.

The same sequence of operations — add, share_prefix, append with a
copy-on-write, window eviction, lease, release — goes to
``repro.kvcache.paged_kv.PagedKVCache`` and to the port's, with the same
numpy-made K/V.  Host state (``stats()``, ``batch_tables()``) must be equal,
the pools and ``lease_kv`` bitwise equal, and ``attend`` within the kernel
tolerance (fp32 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache.paged_kv import ContiguousKVCache as JaxContiguous
from repro.kvcache.paged_kv import PagedKVCache as JaxPaged
from repro.kvcache.paged_kv import PagedKVConfig as JaxConfig
from repro_torch.kvcache.paged_kv import ContiguousKVCache, PagedKVCache, PagedKVConfig

L, KVH, D, PS = 2, 2, 8, 4


class Both:
    """One op stream, two caches."""

    def __init__(self, **cfg):
        self.jax = JaxPaged(JaxConfig(**cfg))
        self.port = PagedKVCache(PagedKVConfig(**cfg), device="cpu")

    def add(self, seq, k, v):
        self.jax.add_sequence(seq, jnp.asarray(k), jnp.asarray(v))
        self.port.add_sequence(seq, torch.from_numpy(k), torch.from_numpy(v))

    def append(self, seq, k, v):
        self.jax.append_token(seq, jnp.asarray(k), jnp.asarray(v))
        self.port.append_token(seq, torch.from_numpy(k), torch.from_numpy(v))

    def call(self, name, *args):
        a, b = getattr(self.jax, name)(*args), getattr(self.port, name)(*args)
        assert a == b, (name, a, b)
        return a

    def assert_same(self, seqs):
        assert self.jax.stats() == self.port.stats()
        if seqs:
            (jt, jl), (tt, tl) = self.jax.batch_tables(seqs), self.port.batch_tables(seqs)
            np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
            np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(self.jax.k_pool), self.port.k_pool.numpy())
        np.testing.assert_array_equal(np.asarray(self.jax.v_pool), self.port.v_pool.numpy())


def kv(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_paged_kv_op_stream_matches_reference():
    rng = np.random.default_rng(0)
    c = Both(num_layers=L, num_kv_heads=KVH, head_dim=D, page_size=PS,
             num_pages=24, max_pages_per_seq=6, dtype="float32")
    c.add(1, kv(rng, L, 10, KVH, D), kv(rng, L, 10, KVH, D))
    c.add(2, kv(rng, L, 5, KVH, D), kv(rng, L, 5, KVH, D))
    c.assert_same([1, 2])

    # prefix sharing: whole pages only (10 tokens -> 8)
    assert c.call("share_prefix", 1, 3, 10) == 8
    # the engine's non-aligned prefix: seq 3 holds 6 of the 8 shared
    # positions, so its next append lands in a shared page -> COW copy
    c.jax.seq_len[3] = c.port.seq_len[3] = 6
    c.append(3, kv(rng, L, KVH, D), kv(rng, L, KVH, D))
    assert c.port.stats()["cow_copies"] == 1
    for _ in range(5):                      # across a page boundary
        c.append(3, kv(rng, L, KVH, D), kv(rng, L, KVH, D))
        c.append(2, kv(rng, L, KVH, D), kv(rng, L, KVH, D))
    c.assert_same([1, 2, 3])

    # attention through the page table
    q = kv(rng, 3, 4, D)
    for layer in range(L):
        want = c.jax.attend(layer, jnp.asarray(q), [1, 2, 3], impl="interpret")
        got = c.port.attend(layer, torch.from_numpy(q), [1, 2, 3])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)

    # leases pin the sequence; the one-layer lease goes through page_gather
    for layer in (None, 0, 1):
        ja, tb = c.jax.lease_kv(2, layer=layer), c.port.lease_kv(2, layer=layer)
        assert ja.pages == tb.pages
        np.testing.assert_array_equal(np.asarray(ja.k), tb.k.numpy())
        np.testing.assert_array_equal(np.asarray(ja.v), tb.v.numpy())
        with pytest.raises(RuntimeError, match="lease"):
            c.port.release(2)
        assert c.call("evict_window_prefix", 2, 4) == []
        ja.release()
        tb.release()
    c.assert_same([1, 2, 3])

    # sliding-window eviction, then appends keyed by logical page
    freed = c.call("evict_window_prefix", 2, 4)
    assert freed
    c.append(2, kv(rng, L, KVH, D), kv(rng, L, KVH, D))
    c.assert_same([1, 2, 3])

    for seq in (3, 1, 2):
        c.call("release", seq)
    c.assert_same([])
    assert c.port.allocator.used_pages == 0


def test_adaptive_window_auto_eviction_matches_reference():
    rng = np.random.default_rng(1)
    c = Both(num_layers=1, num_kv_heads=1, head_dim=4, page_size=2,
             num_pages=64, max_pages_per_seq=32, dtype="float32",
             adaptive=True, attention_window=6)
    c.add(0, kv(rng, 1, 3, 1, 4), kv(rng, 1, 3, 1, 4))
    for _ in range(30):
        c.append(0, kv(rng, 1, 1, 4), kv(rng, 1, 1, 4))
    assert c.port.stats()["auto_evicted_pages"] > 0
    assert c.port.detected_phase(0) == c.jax.detected_phase(0) == "sequential"
    c.assert_same([0])


def test_contiguous_baseline_matches_reference():
    rng = np.random.default_rng(2)
    jc = JaxContiguous(1, 1, 4, max_seqs=4, max_len=16, dtype="float32")
    tc = ContiguousKVCache(1, 1, 4, max_seqs=4, max_len=16, dtype="float32", device="cpu")
    for sid, n in enumerate([5, 9, 3]):
        k = kv(rng, 1, n, 1, 4)
        jc.add_sequence(sid, jnp.asarray(k), jnp.asarray(k))
        tc.add_sequence(sid, torch.from_numpy(k), torch.from_numpy(k))
    t = kv(rng, 1, 1, 4)
    jc.append_token(1, jnp.asarray(t), jnp.asarray(t))
    tc.append_token(1, torch.from_numpy(t), torch.from_numpy(t))
    assert jc.release(0) == tc.release(0)
    assert (jc.reserved_tokens(), jc.used_tokens()) == (tc.reserved_tokens(), tc.used_tokens())
    np.testing.assert_array_equal(np.asarray(jc.k), tc.k.numpy())
    assert PagedKVConfig(1, 3, 64, page_size=16).page_bytes == \
        JaxConfig(1, 3, 64, page_size=16).page_bytes

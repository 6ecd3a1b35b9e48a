"""The yardstick's arithmetic: the H100's peaks, the attention kernels'
operations and bytes from each launch's real shapes and lengths, and the
model FLOPs a token of each configuration.

Frozen here, under the benchmark's own folder, so that a change to the
program cannot change how it is measured.  The attention formulas follow
``repro_torch/kernels/meta.py`` where both count the same keys (whole
tables, no window; a CPU test holds them equal); where meta tensors have
no lengths, these count the keys each sequence really has.

Model FLOPs count the configuration's work, not what an implementation
launches: 2 FLOPs a weight a token for every product the token needs (for
an MoE layer the router and its ``num_experts_per_tok`` routed experts
only), and 4·heads·head_dim FLOPs a visible (query, key) pair.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
PEAK_BYTES = 3.35e12              # B/s, HBM3


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: compute- or bandwidth-bound."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


def visible_keys(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """``sum_q visible(q)`` over ``sq`` query rows and ``sk`` keys, top-left
    aligned: key ``k`` is visible to row ``q`` iff ``k <= q`` (causal) and
    ``q - k < window``.  Summed piecewise as arithmetic series."""
    w = window or 0

    def f(q):
        hi = min(q + 1, sk) if causal else sk
        lo = max(q - w + 1, 0) if window else 0
        return max(hi - lo, 0)

    kinks = (sk - 1, w - 1, sk + w - 1)
    cuts = sorted({0, sq} | {c + e for c in kinks for e in (0, 1) if 0 < c + e < sq})
    return sum((f(a) + f(b - 1)) * (b - a) // 2 for a, b in zip(cuts, cuts[1:]))


def flash_attention_cost(b: int, h: int, sq: int, d: int, kvh: int, sk: int,
                         elt: int, causal: bool = True, window: Optional[int] = None,
                         num_heads: Optional[int] = None, head_offset: int = 0):
    """(flops, bytes) of one prefill attention launch over q [b, h, sq, d]
    and K / V [b, kvh, sk, d]: the real heads' visible pairs; q's real
    heads, the K / V groups they read and the whole output, once each."""
    nh = head_offset + h if num_heads is None else num_heads
    lo, hi = head_offset, min(nh, head_offset + h)
    real = max(hi - lo, 0)
    rep = max(nh // kvh, 1)
    groups = (hi - 1) // rep - lo // rep + 1 if real else 0
    flops = 4 * b * real * d * visible_keys(sq, sk, causal, window)
    nbytes = (b * real * sq * d + 2 * b * groups * sk * d + b * h * sq * d) * elt
    return flops, nbytes


def paged_attention_cost(lengths: Sequence[int], h: int, d: int, kvh: int,
                         page_size: int, elt: int, num_heads: Optional[int] = None,
                         window: Optional[int] = None):
    """(flops, bytes) of one decode attention launch: one query token per
    sequence over the keys its length (after the step's write) and the
    window leave it; bytes of q's real heads, those keys' K and V rows,
    the table entries of their pages, the lengths and the output."""
    nh = h if num_heads is None else num_heads
    b = len(lengths)
    keys = [min(n, window) if window else n for n in lengths]
    pages = sum(-(-n // page_size) for n in lengths)
    flops = 4 * nh * d * sum(keys)
    nbytes = ((b * nh * d + 2 * sum(keys) * kvh * d + b * h * d) * elt
              + pages * 4 + b * 4)
    return flops, nbytes


class ModelFlops:
    """FLOPs of one configuration's work, from its ``configs/<name>.json``
    (published key names)."""

    def __init__(self, cfg: dict):
        d = cfg["hidden_size"]
        h = cfg["num_attention_heads"]
        kv = cfg["num_key_value_heads"]
        hd = d // h
        f = cfg["intermediate_size"]
        self.layers = cfg["num_hidden_layers"]
        self.window = cfg.get("sliding_window")
        self.attn_pair = 4 * h * hd                  # QK^T and PV, per layer
        proj = d * h * hd + 2 * d * kv * hd + h * hd * d
        e = cfg.get("num_local_experts") or 0
        if e:
            ffn = d * e + cfg["num_experts_per_tok"] * 3 * d * f
        else:
            ffn = 3 * d * f
        self.per_token_layers = 2 * self.layers * (proj + ffn)
        self.head = 2 * d * cfg["vocab_size"]

    def pairs(self, start: int, stop: int) -> int:
        """Visible (query, key) pairs of query positions ``[start, stop)``
        over every key before them (causal, within the window)."""
        if stop <= start:
            return 0
        return (visible_keys(stop, stop, True, self.window)
                - visible_keys(start, start, True, self.window))

    def prefill(self, start: int, stop: int) -> float:
        """Prefill of positions ``[start, stop)`` into the cache (no logits:
        the last prompt token is the first decode step's input)."""
        n = max(stop - start, 0)
        return n * self.per_token_layers + self.layers * self.attn_pair * self.pairs(start, stop)

    def decode(self, positions: Iterable[int]) -> float:
        """Decode steps at these positions, each attending every key up to
        its own, with the logits."""
        total = 0.0
        for p in positions:
            keys = p + 1 if not self.window else min(p + 1, self.window)
            total += self.per_token_layers + self.head + self.layers * self.attn_pair * keys
        return total

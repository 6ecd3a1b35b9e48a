"""The general traffic generator: a mix's parameters -> the requests of one run.

Every seed gets the same requests' sizes and the same arrival gaps, in
another order: each length is a quantile of its distribution at
``(i + 0.5) / n`` (lognormal by median and sigma, clipped), each prefix
count the rounded share of its Zipf weight, each gap a quantile of the
arrival kind's own distribution.  The lengths are paired into requests
(prefix, body, output) by a fixed permutation, the same for every seed;
the seed orders the requests and the gaps and draws the token ids.  So
runs with different seeds do the same work, and the seed changes only its
order and its tokens.

A mix file (``traffic/<mix>.json``) holds:

* ``arrivals``: ``{"kind": <traffic/kinds/<kind>.py>, ...}`` and the
  kind's own parameters;
* ``engine``: the ``EngineConfig`` fields the mix fixes (``max_batch``,
  ``page_size``, ``prefill_bucket``) and ``max_context``, the longest
  context a request reaches (prompt plus output), which sizes the tables;
* ``prefix`` (optional): ``lengths`` of the prefixes, ``zipf_s`` for
  choosing one, and ``register``: shared prefixes registered with the
  engine at set-up, or, false, a fresh prefix of that length for every
  request (the unshared control);
* ``body``: the prompt's own part past any prefix, and ``output``: the
  tokens to generate, each ``{"median", "sigma", "min", "max"}``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import List, Optional

import numpy as np

KINDS = Path(__file__).resolve().parent / "kinds"
SCHEDULE_SEED = 20240102         # pairs and orders the requests, whatever the run's seed


@dataclasses.dataclass
class Item:
    """One request of the run, before it meets the engine."""

    rid: int
    prompt: np.ndarray          # int32 token ids
    max_new_tokens: int
    due_s: float                # scheduled arrival, seconds into the window
    prefix: Optional[int]       # index into Traffic.prefixes, or None
    shared_tokens: int          # leading tokens a registered prefix holds


@dataclasses.dataclass
class Traffic:
    mix: dict
    kind: object                # the arrival kind's module
    items: List[Item]           # in the window, in due order
    warm: List[Item]            # in service when the window opens
    prefixes: List[np.ndarray]  # registered at set-up


def load_mix(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_kind(name: str, kinds_dir: Path = KINDS):
    path = Path(kinds_dir) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cellbench_kind_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lognormal_quantiles(n: int, spec: dict) -> np.ndarray:
    """n lengths: the lognormal's quantiles at (i + 0.5) / n, rounded and
    clipped to [min, max]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(vals, spec["min"], spec["max"]).astype(np.int64)


def residual_quantiles(n: int, lengths: np.ndarray) -> np.ndarray:
    """n remaining lengths of requests caught in service: the residual of
    ``lengths`` (P(r = k) proportional to the share with length >= k)."""
    k = np.arange(1, int(lengths.max()) + 1)
    w = np.array([(lengths >= x).sum() for x in k], dtype=np.float64)
    cdf = np.cumsum(w) / w.sum()
    u = (np.arange(n) + 0.5) / n
    return k[np.searchsorted(cdf, u)]


def zipf_counts(n: int, m: int, s: float) -> np.ndarray:
    """Counts of m choices over n draws in proportion to 1 / rank**s, by
    largest remainder."""
    p = 1.0 / np.arange(1, m + 1) ** s
    p /= p.sum()
    raw = n * p
    counts = np.floor(raw).astype(np.int64)
    rest = n - counts.sum()
    counts[np.argsort(-(raw - counts), kind="stable")[:rest]] += 1
    return counts


def build(mix: dict, seed: int, seconds: float, vocab: int,
          kinds_dir: Path = KINDS) -> Traffic:
    rng = np.random.default_rng(seed)
    kind = load_kind(mix["arrivals"]["kind"], kinds_dir)
    n = kind.count(mix["arrivals"], seconds)
    due = kind.due(mix["arrivals"], seconds, n, np.random.default_rng(SCHEDULE_SEED))
    warm_n = kind.warm_lanes(mix["arrivals"], mix["engine"])

    pre = mix.get("prefix")
    pre_len = np.asarray(pre["lengths"], np.int64) if pre else None
    shared = bool(pre and pre.get("register"))
    prefixes = ([rng.integers(0, vocab, size=int(x)).astype(np.int32) for x in pre_len]
                if shared else [])

    def draw(count: int, out_lengths: np.ndarray, start_rid: int, due_s) -> List[Item]:
        fixed = np.random.default_rng(SCHEDULE_SEED)
        body = fixed.permutation(lognormal_quantiles(count, mix["body"]))
        outs = fixed.permutation(out_lengths)
        if pre:
            choice = fixed.permutation(np.repeat(np.arange(len(pre_len)),
                                                 zipf_counts(count, len(pre_len), pre["zipf_s"])))
        items = []
        for i in range(count):
            head, p_idx = np.zeros(0, np.int32), None
            if pre:
                p_idx = int(choice[i])
                head = (prefixes[p_idx] if shared else
                        rng.integers(0, vocab, size=int(pre_len[p_idx])).astype(np.int32))
            tail = rng.integers(0, vocab, size=int(body[i])).astype(np.int32)
            items.append(Item(rid=start_rid + i, prompt=np.concatenate([head, tail]),
                              max_new_tokens=int(outs[i]), due_s=float(due_s[i]),
                              prefix=p_idx if shared else None,
                              shared_tokens=len(head) if shared else 0))
        return items

    items = draw(n, lognormal_quantiles(n, mix["output"]), 0, due)
    warm = []
    if warm_n:
        # one token of each is generated in set-up, the rest in the window
        left = residual_quantiles(warm_n, lognormal_quantiles(max(n, warm_n), mix["output"]))
        warm = draw(warm_n, left + 1, n, np.zeros(warm_n))
    longest = max(len(r.prompt) + r.max_new_tokens for r in items + warm)
    if longest > mix["engine"]["max_context"]:
        raise ValueError(f"a request reaches {longest} tokens, past max_context "
                         f"{mix['engine']['max_context']}")
    return Traffic(mix=mix, kind=kind, items=items, warm=warm, prefixes=prefixes)


def pages_per_seq(mix: dict) -> int:
    e = mix["engine"]
    return math.ceil(e["max_context"] / e["page_size"]) + 1

"""The general traffic generator: seeded, and the same work for every seed."""

import json
from pathlib import Path

import numpy as np
import pytest

import cb_support  # noqa: F401  (puts the repo root and src on the path)
from cellbench.traffic import generate

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def _sig(t):
    return [(r.rid, r.prompt.tobytes(), r.max_new_tokens, r.due_s, r.prefix)
            for r in t.items + t.warm]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = generate.load_mix(TRAFFIC / f"{mix}.json")
    a = generate.build(m, 3141592653589, 6.0, 1000)
    b = generate.build(m, 3141592653589, 6.0, 1000)
    assert _sig(a) == _sig(b) and len(a.items) > 0
    assert [p.tobytes() for p in a.prefixes] == [p.tobytes() for p in b.prefixes]


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_the_schedule(mix):
    m = generate.load_mix(TRAFFIC / f"{mix}.json")
    a, b = (generate.build(m, s, 6.0, 1000) for s in (7, 2 ** 31 + 11))
    shape = lambda t: [(len(r.prompt), r.max_new_tokens, r.due_s, r.prefix,  # noqa: E731
                        r.shared_tokens) for r in t.items + t.warm]
    assert shape(a) == shape(b)
    assert _sig(a) != _sig(b)           # the tokens are the seed's


def test_lengths_within_their_clips_and_context():
    for mix in MIXES:
        m = generate.load_mix(TRAFFIC / f"{mix}.json")
        t = generate.build(m, 5, 10.0, 1000)
        body_lo = m["body"]["min"] + (min(m["prefix"]["lengths"]) if "prefix" in m else 0)
        assert min(len(r.prompt) for r in t.items) >= body_lo
        assert all(m["output"]["min"] <= r.max_new_tokens <= m["output"]["max"] for r in t.items)
        assert max(len(r.prompt) + r.max_new_tokens for r in t.items) <= m["engine"]["max_context"]


def test_poisson_fills_the_window_and_backlog_is_due_at_once():
    kinds = TRAFFIC / "kinds"
    p = generate.load_kind("poisson", kinds)
    due = p.due({"rate_per_s": 4.0}, 30.0, p.count({"rate_per_s": 4.0}, 30.0),
                np.random.default_rng(0))
    assert len(due) == 120 and due[0] == 0.0 and 29.0 < due[-1] < 30.0
    assert np.all(np.diff(due) > 0)
    b = generate.load_kind("backlog", kinds)
    assert not b.OPEN and b.warm_lanes({}, {"max_batch": 48}) == 48


def test_prefix_shares_follow_zipf_and_residual_is_length_biased():
    c = generate.zipf_counts(100, 8, 1.0)
    assert c.sum() == 100 and list(c) == sorted(c, reverse=True) and c[0] == 37
    lengths = generate.lognormal_quantiles(200, {"median": 96, "sigma": 0.6, "min": 32,
                                                 "max": 256})
    res = generate.residual_quantiles(48, lengths)
    assert res.min() >= 1 and res.max() <= lengths.max() and np.median(res) < np.median(lengths)


def test_shared_mix_registers_prefixes_unshared_does_not():
    s = generate.build(json.loads((TRAFFIC / "shared-prefix.json").read_text()), 1, 5.0, 500)
    u = generate.build(json.loads((TRAFFIC / "unshared.json").read_text()), 1, 5.0, 500)
    assert len(s.prefixes) == 8 and all(len(p) % 16 for p in s.prefixes)
    assert all(r.prompt[:r.shared_tokens].tobytes() == s.prefixes[r.prefix].tobytes()
               for r in s.items)
    assert not u.prefixes and all(r.shared_tokens == 0 for r in u.items)

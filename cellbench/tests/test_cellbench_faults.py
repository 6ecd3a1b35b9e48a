"""The check catches a broken timed path: each fault a serving cell can
have, planted in the program underneath a smoke run (the look for a card
skipped), turns ``correct`` false."""

import contextlib

import pytest

from cb_support import OPEN, SAT, hold_to, run_smoke, smoke_root


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def token_altered(orig):
    """One decode step's tokens altered where they are produced."""
    calls = [0]

    def step(*a, **kw):
        logits, caches = orig(*a, **kw)
        calls[0] += 1
        return (logits.roll(1, dims=-1) if calls[0] == 6 else logits), caches
    return step


def state_unchanged(orig):
    """A decode step that leaves the KV pool as it was (no token written)."""
    def write(cache, k, v):
        return {"k_pool": cache["k_pool"], "v_pool": cache["v_pool"],
                "table": cache["table"], "len": cache["len"] + 1}
    return write


def half_batch(orig):
    """Half of the batch left out: the later half of the live lanes (those
    at a position past 0) get the first live lane's logits."""
    def step(cfg, params, caches, tokens, cur_pos, *a, **kw):
        logits, caches = orig(cfg, params, caches, tokens, cur_pos, *a, **kw)
        live = cur_pos.nonzero()[:, 0]
        if len(live) > 1:
            logits = logits.clone()
            logits[live[len(live) // 2:]] = logits[live[0]].clone()
        return logits, caches
    return step


FAULTS = {"token_altered": ("transformer", "decode_step", token_altered),
          "state_unchanged": ("blocks", "_write_paged_cache", state_unchanged),
          "half_batch": ("transformer", "decode_step", half_batch)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("cbf"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [OPEN, SAT])
def test_fault_is_not_correct(root, fault, cell):
    import repro_torch.models.blocks as blocks
    import repro_torch.models.transformer as transformer

    mod, name, make = FAULTS[fault]
    with patched({"blocks": blocks, "transformer": transformer}[mod], name, make):
        out = run_smoke(root, cell, seconds=0.6)
    assert any(c["value"] > c["limit"] for n, c in out["checks"].items() if n != "tokens_checked")
    assert out["correct"] is False


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_the_mixtral_number_catches_lane_and_state_faults(tmp_path, fault):
    """The Mixtral cell compares the 90th percentile of the gaps, which a
    fault in many of the served tokens moves: half of the lanes given
    another lane's logits, or a decode step that writes no KV.  (A single
    altered token it cannot see; the dense cells' widest gap does.)"""
    import repro_torch.models.blocks as blocks
    import repro_torch.models.transformer as transformer

    root = smoke_root(tmp_path)
    hold_to(root, SAT, "mixtral-8x7b-16l.long-prompt")
    mod, name, make = FAULTS[fault]
    with patched({"blocks": blocks, "transformer": transformer}[mod], name, make):
        out = run_smoke(root, SAT, seconds=0.6)
    assert set(out["checks"]) == {"p90_gap", "tokens_checked"}
    assert out["checks"]["p90_gap"]["value"] > out["checks"]["p90_gap"]["limit"]
    assert out["correct"] is False

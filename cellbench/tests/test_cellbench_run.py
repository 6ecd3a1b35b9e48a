"""Smoke runs of a whole cell on the CPU (the port's smoke configurations,
plain PyTorch in place of the kernels), added to a copy of cellbench/ as
new files only, with one new per-layer metric."""

import json

import pytest

from cb_support import OPEN, SAT, smoke_root, run_smoke

NEW_METRIC = "smoke_prompt_tokens"
READER = '''"""A metric a later change could add: prompt tokens of the window's requests."""


def read(run):
    return sum(len(r.item.prompt) for r in run.window.reqs if r.in_window)
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = smoke_root(tmp_path_factory.mktemp("cb"), extra_metric=NEW_METRIC)
    (r / "cellbench" / "metrics" / f"{NEW_METRIC}.py").write_text(READER)
    return r


def _shape(out, keys):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    json.dumps({k: v for k, v in out.items() if k != "window"})
    assert set(out["metrics"]) == keys
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] is not None
    assert set(out["checks"]) == {"logit_gap", "mean_gap", "tokens_checked"}


@pytest.mark.parametrize("cell,keys", [
    (OPEN, {"ttft_p95_ms", "itl_p99_ms", "setup_s"}),
    (SAT, {"itl_p99_ms", "out_tok_s", "setup_s"})])
def test_smoke_cell_untraced(root, cell, keys):
    out = run_smoke(root, cell)
    _shape(out, keys)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] <= c["limit"] for n, c in out["checks"].items() if n != "tokens_checked")


def test_smoke_cell_traced_reads_the_new_metric(root):
    out = run_smoke(root, OPEN, trace=True)
    assert out["correct"]
    # the CPU has no device trace: only the host's and the program's numbers
    assert set(out["metrics"]) == {"queue_wait_p95_ms.open", "prefix_hit_share.open",
                                   "prefill_ms_per_ktok.open", "decode_step_ms", NEW_METRIC}
    assert out["metrics"]["prefix_hit_share.open"]["value"] == 100.0
    assert out["metrics"][NEW_METRIC]["value"] > 0
    assert "breakdown" in out and "busy_s" in out["device"]

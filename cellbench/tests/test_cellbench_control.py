"""The control: the reference one precision below bfloat16 (float8 inputs
to every product, ``reference/quant.py``) put in the program's place must
read a wider served-token gap than the program.  At the cells' own sizes
on the card the readings come from ``cellbench/control.py`` (``PERF.md``);
here on the CPU at the smoke size, and on a card at deepseek-7b's widths
over 4 of its 30 layers."""

import json
import shutil

import pytest
import torch

from cb_support import OPEN, REPO, SAT, run_smoke, smoke_root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", [OPEN, SAT])
def test_control_reads_wider_than_the_program_cpu(tmp_path, cell):
    out = run_smoke(smoke_root(tmp_path), cell, seed=31415926535, seconds=1.0, control=True)
    assert out["correct"] is True
    # the control, held to the same limits by the same code, is not correct
    assert out["control"]["correct"] is False
    assert set(out["control"]["checks"]) == set(out["checks"])
    for name, c in out["checks"].items():
        if name != "tokens_checked":
            assert c["value"] <= c["limit"]


@pytest.mark.cuda
def test_control_reads_wider_than_the_program_card(tmp_path, card):
    from cellbench.bench import Bench
    from cellbench.cell import run_cell

    root = tmp_path / "root"
    shutil.copytree(REPO / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((REPO / "cellbench/configs/deepseek-7b.json").read_text())
    cfg.update(name="deepseek-7b-4l", num_hidden_layers=4)
    cfg["program"]["overrides"]["num_layers"] = 4
    (root / "cellbench/configs/deepseek-7b-4l.json").write_text(json.dumps(cfg))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "deepseek-7b-4l", "source": cfg["source"],
                            "file": "cellbench/configs/deepseek-7b-4l.json",
                            "reduced": ["num_hidden_layers"], "why": "control test"})
    spec["workloads"].append({"name": "deepseek-7b-4l.shared-prefix", "config": "deepseek-7b-4l",
                              "traffic": "shared-prefix", "chips": 1, "why": "control test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(REPO / "cellbench/limits/deepseek-7b.shared-prefix.json",
                root / "cellbench/limits/deepseek-7b-4l.shared-prefix.json")
    out = run_cell(Bench(root), "deepseek-7b-4l.shared-prefix", 27182818284, 8.0, trace=False,
                   device="cuda", control=True)
    program, control = out["info"]["gaps"], out["control"]["gaps"]
    assert control["mean_gap"] >= 3 * program["mean_gap"], (program, control)
    assert out["correct"] is True and out["control"]["correct"] is False

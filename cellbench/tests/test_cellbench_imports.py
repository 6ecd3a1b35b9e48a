"""Nothing the benchmark runs loads the JAX side (``jax``, ``jaxlib``,
``flax``, the JAX package ``repro``; names compared whole, so the port
``repro_torch`` is allowed), the reference loads nothing of the port,
and ``run.py`` prints no result without a card or without the program."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cb_support import REPO

CB = REPO / "cellbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_side_and_reference_no_program():
    for path in CB.rglob("*.py"):
        if "tests" in path.relative_to(CB).parts:
            continue
        names = set(_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if path.relative_to(CB).parts[0] == "reference":
            assert "repro_torch" not in names and "cellbench" not in names, path


SCRIPT = r"""
import json, sys
sys.path[0:0] = [{tests!r}]
import cellbench.reference.model, cellbench.reference.quant
ref_only = sorted({{m.split(".")[0] for m in sys.modules}})
from cb_support import OPEN, smoke_root, run_smoke
import tempfile
with tempfile.TemporaryDirectory() as d:
    out = run_smoke(smoke_root(d), OPEN, seconds=1.0)
print(json.dumps({{"correct": out["correct"], "ref_only": ref_only,
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax_side_and_the_reference_no_program():
    code = SCRIPT.format(tests=str(CB / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and "repro_torch" in res["top"]
    assert not FORBIDDEN & set(res["top"])
    assert "repro_torch" not in res["ref_only"] and not FORBIDDEN & set(res["ref_only"])


def _run_py(cwd: Path):
    return subprocess.run([sys.executable, "cellbench/run.py", "--workload",
                           "deepseek-7b.shared-prefix", "--seed", "4294967311", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=cwd)


def test_run_py_prints_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    p = _run_py(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_py_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(CB, tmp_path / "cellbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""

"""Hand-written CUDA kernels of the port: build, load, launch counts.

Each ``csrc/<name>.cu`` exports plain C functions.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so``
under the repository root (git-ignored; the hash is of the source and the
local ``csrc/*.cuh`` headers it includes, so an edited source or header
rebuilds) and loaded with ``ctypes``.  Nothing links against libcuda: a
kernel that needs one of its functions (the TMA tensor-map encoder) looks
it up through the runtime.  :func:`build_all` starts one ``nvcc`` per
source at once.  Nothing is built or loaded when this package is imported:
the CPU tests import every module, and there is no ``nvcc`` there.

A kernel that fails to build or launch raises; no wrapper falls back to
the plain PyTorch version.  Each wrapper adds one to
``launch_counts[<name>]`` where it launches its kernel, and nowhere else.
On ``meta`` tensors (the dry run) each op's ``"auto"`` takes its kernel's
meta implementation (``meta.py``), which launches nothing and adds the
call, its flops and its bytes under the kernel's own formula to
``meta_costs[<name>]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "page_gather", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts: Dict[str, int] = {"paged_attention": 0, "page_gather": 0,
                                 "page_scatter": 0, "flash_attention": 0}

meta_costs: Dict[str, Dict[str, int]] = {
    k: {"calls": 0, "flops": 0, "bytes": 0} for k in launch_counts}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def reset_meta_costs() -> None:
    for costs in meta_costs.values():
        for k in costs:
            costs[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built at first use on the card's host")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _local_headers(path: Path) -> List[Path]:
    """Every header under ``csrc`` that ``path`` includes with quotes,
    directly or through another such header, in include order."""
    found: List[Path] = []
    todo = [path]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_bytes()):
            header = (CSRC / inc.decode()).resolve()
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def _lib_path(name: str) -> Path:
    """``build/kernels/<name>-<hash>.so``; the hash covers the source, every
    local header it includes and the flags, so editing any of them rebuilds."""
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in _local_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns each source's ``-Xptxas -v`` report (registers,
    shared memory, spills); raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs: List[tuple] = []
    reports: Dict[str, str] = {}
    for name in names:
        out = _lib_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            reports[name] = log.read_text() if log.exists() else ""
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, log, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, out)      # atomic: a concurrent loader never sees half a file
        reports[name] = text
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    """Raise on a refused launch (the C side returns ``cudaGetLastError``);
    otherwise count the launch in ``launch_counts[name]``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {err}")
    launch_counts[name] += 1

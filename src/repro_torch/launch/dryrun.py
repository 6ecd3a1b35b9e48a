"""Meta-device dry run of (arch × shape × production mesh) cells (port of
``repro/launch/dryrun.py``).

For one cell: builds the production mesh (16x16 single pod / 2x16x16 multi
pod) as a :class:`MeshSpec`, assembles the cell under ``rules_for(kind,
cfg)`` (``launch/specs.build_cell``) with its arguments on the ``meta``
device, and accounts, per device, without executing: the arguments' bytes
(params, plus opt state or cache, plus batch; each leaf's bytes divided by
the product of the mesh sizes its spec names), the outputs' bytes, the
parameter count and the replicated / sharded parameter leaves.

Then it executes rank 0's program of the cell on ``meta``
(:func:`account_cell`): in a child process whose default process group is
a ``"fake"`` one of the mesh's size (collectives return at once and move
nothing), under a ``DeviceMesh`` of the production mesh's shape and names,
``cell.fn`` runs on rank 0's shards of the arguments (``local_tree``), as
the card runs it: remat, ZeRO-1 and the vocab-parallel loss included.  The
kernels take their meta implementations (``kernels/meta.py``).
``launch/accounting.py`` counts what runs, and the record gains, per
device, under the reference's names:

* ``flops``: matmul-class flops of the rank's program (every layer counts:
  the port has no scan), plus each kernel's flops under its own formula;
* ``bytes_accessed``: each dispatched op's input and output bytes (the
  unfused eager count, which is what the card runs), plus each kernel's
  bytes under its own formula;
* ``collectives``: operand bytes by kind, ``total`` and ``counts``;
* ``memory.peak_bytes`` (the high-water mark of live storage, arguments
  included) and ``memory.temp_bytes`` (``peak_bytes - argument_bytes``);
* ``kernels``: each kernel's calls, flops and bytes;
* ``run_s``: the seconds of the meta execution.  It stands where the
  reference has ``lower_s`` / ``compile_s``, which have no counterpart:
  the port neither lowers nor compiles.

``fits`` is ``peak_bytes <= hbm_bytes`` (without execution, as the tests
of the argument bytes run it: ``argument_bytes <= hbm_bytes``).  A cell
that fails to build or execute keeps ``ok: false`` and its ``error``.  No
device is touched.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--multi-pod] [--out build/dryrun]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

from ..configs.base import SHAPES, ModelConfig, ShapeConfig
from ..configs.registry import get_config
from ..distributed.sharding import entry_axes, mesh_spec, use_mesh
from ..interop import tree_flatten
from ..models.common import count_params, is_tuple
from .mesh import hbm_bytes, make_production_mesh, rules_for


def per_device_bytes(tensors, specs, mesh) -> int:
    """Bytes one device holds of ``tensors`` laid out by ``specs``."""
    sizes = mesh_spec(mesh).sizes
    leaves = tree_flatten(tensors)[0]
    spec_leaves = tree_flatten(specs, is_tuple)[0]
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    total = 0
    for t, spec in zip(leaves, spec_leaves):
        parts = math.prod(sizes[a] for e in spec for a in entry_axes(e))
        total += t.numel() * t.element_size() // parts
    return total


# ------------------------------------------------------------- execution


def fake_world(size: int) -> None:
    """Make this process's default group a ``"fake"`` one of ``size`` ranks
    with this process as rank 0 (replacing an earlier fake one).  Refuses
    to replace a real group: the dry run executes in a process of its own
    (:func:`account_cells`)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry run executes under a fake process group, not the "
                               f"caller's {dist.get_backend()} one: use account_cells")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def account_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: Sequence[int],
                 axis_names: Sequence[str], tcfg=None) -> dict:
    """Execute rank 0's program of the cell on ``meta`` under a fake group of
    the mesh's size (made here) and a DeviceMesh of ``mesh_shape`` /
    ``axis_names``; returns its per-device accounting (the module note)."""
    from torch.distributed.device_mesh import init_device_mesh

    from .. import kernels as K
    from .accounting import Accounting
    from .specs import build_cell, local_tree

    fake_world(math.prod(mesh_shape))
    mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=tuple(axis_names))
    with use_mesh(mesh, rules_for(shape.kind, cfg)):
        cell = build_cell(cfg, shape, mesh, tcfg)
    args = [local_tree(a, s, mesh) for a, s in zip(cell.args, cell.in_specs)]
    gc.collect()                # no earlier cell's garbage freed inside this one
    acc = Accounting("meta")
    K.reset_meta_costs()
    t0 = time.perf_counter()
    with acc:
        acc.track(args)
        executed_argument_bytes = acc.current
        out = cell.fn(*args)
    run_s = time.perf_counter() - t0
    del out
    kernels = {k: dict(v) for k, v in K.meta_costs.items() if v["calls"]}
    return {
        "flops": acc.flops + sum(v["flops"] for v in kernels.values()),
        "bytes_accessed": acc.bytes_accessed + sum(v["bytes"] for v in kernels.values()),
        "collectives": acc.collectives,
        "kernels": kernels,
        "peak_bytes": acc.peak,
        "executed_argument_bytes": executed_argument_bytes,
        "run_s": run_s,
    }


def _child_init(nice: int) -> None:
    """A child of :func:`account_pool`: one thread, ``nice`` added to its
    niceness, the port's deprecation and DTensor notices silenced."""
    import logging
    import warnings

    import torch

    torch.set_num_threads(1)
    if nice:
        os.nice(nice)
    warnings.simplefilter("ignore", FutureWarning)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)


def _account_job(job: tuple) -> dict:
    """A child's entry: :func:`account_cell` of ``job``, failures recorded."""
    try:
        return account_cell(*job)
    except Exception as e:  # noqa: BLE001 - record failures, don't crash sweep
        return {"error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def account_pool(workers: int, nice: int = 0):
    """``workers`` spawned child processes for :func:`account_cells` (the
    fake group is process-global: the caller's own group, if any, stays as
    it was).  The caller closes it (``terminate``, or ``with``)."""
    import multiprocessing as mp

    return mp.get_context("spawn").Pool(max(1, workers), initializer=_child_init,
                                        initargs=(nice,))


def account_cells(jobs: Sequence[tuple], workers: int = 1, pool=None) -> list:
    """:func:`account_cell` of each ``(cfg, shape, mesh_shape, axis_names,
    tcfg)`` job, in order, in ``pool`` (else in a pool of ``workers`` made
    for them).  A job that fails returns its ``error`` and ``traceback``."""
    jobs = list(jobs)
    if not jobs:
        return []
    if pool is not None:
        return pool.map(_account_job, jobs, chunksize=1)
    with account_pool(min(workers, len(jobs))) as own:
        return own.map(_account_job, jobs, chunksize=1)


# ---------------------------------------------------------------- records


def _mesh_name(multi_pod: bool, variant: str) -> str:
    name = "pod2x16x16" if multi_pod else "pod16x16"
    return f"{name}__{variant}" if variant else name


def static_record(arch: str, shape_name: str, multi_pod: bool,
                  overrides: Optional[dict] = None, variant: str = "") -> dict:
    """The cell's record without execution: the argument and output bytes,
    the parameter count and leaves, ``hbm_bytes``, ``fits`` by the
    arguments alone."""
    from .specs import build_cell

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod, variant),
        "kind": shape.kind, "devices": mesh.size, "ok": False,
        "overrides": overrides or {}, "variant": variant,
    }
    t0 = time.time()
    try:
        with use_mesh(mesh, rules_for(shape.kind, cfg)):
            cell = build_cell(cfg, shape, mesh)
        args, specs = list(cell.args), list(cell.in_specs)
        if shape.kind == "decode":      # (params, cache, tokens, cur_pos)
            args[2:], specs[2:] = [args[2:]], [specs[2:]]
        parts = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch"),
                 "decode": ("params", "cache", "batch")}[shape.kind]
        by_part = {k: per_device_bytes(a, sp, mesh) for k, a, sp in zip(parts, args, specs)}
        p_specs = tree_flatten(cell.in_specs[0], is_tuple)[0]
        sharded = sum(any(e is not None for e in s) for s in p_specs)
        arg_bytes = sum(by_part.values())
        hbm = hbm_bytes()
        rec.update(
            ok=True,
            params=count_params(cell.args[0]),
            replicated_leaves=len(p_specs) - sharded,
            sharded_leaves=sharded,
            memory={"argument_bytes": arg_bytes,
                    "output_bytes": per_device_bytes(list(cell.out), list(cell.out_specs), mesh),
                    "argument_bytes_by_part": by_part},
            hbm_bytes=hbm,
            fits=arg_bytes <= hbm,
        )
    except Exception as e:  # noqa: BLE001 - record failures, don't crash sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 3)
    return rec


def _merge(rec: dict, res: dict) -> None:
    """Add an execution's accounting to a static record."""
    if "error" in res:
        rec.update(ok=False, fits=None, error=res["error"], traceback=res["traceback"])
        return
    mem = rec["memory"]
    mem.update(peak_bytes=res["peak_bytes"], temp_bytes=res["peak_bytes"] - mem["argument_bytes"])
    rec.update(flops=res["flops"], bytes_accessed=res["bytes_accessed"],
               collectives=res["collectives"], kernels=res["kernels"],
               run_s=round(res["run_s"], 3), fits=res["peak_bytes"] <= rec["hbm_bytes"])
    if res["executed_argument_bytes"] != mem["argument_bytes"]:
        rec.update(ok=False, error=f"executed arguments hold {res['executed_argument_bytes']} "
                                   f"bytes, the specs {mem['argument_bytes']}")


@dataclasses.dataclass
class PendingCells:
    """Cells whose static records are made and whose execution runs in a
    pool (:func:`start_cells`); :func:`finish_cells` waits for it."""

    records: list
    todo: list
    result: object
    started: float                       # perf_counter() at the start
    finished: list = dataclasses.field(default_factory=list)   # [perf_counter() at the end]

    @property
    def seconds(self) -> Optional[float]:
        """The execution's wall seconds, once it has ended."""
        return self.finished[0] - self.started if self.finished else None


def start_cells(cells: Sequence[tuple], pool=None) -> PendingCells:
    """The static records of ``(arch, shape_name, multi_pod[, overrides,
    variant])`` cells, now; with ``pool``, every cell that builds set
    executing there (the longest first), without waiting."""
    cells = [tuple(c) + ({}, "")[len(c) - 3:] for c in cells]
    recs = [static_record(*c) for c in cells]
    todo = sorted((i for i, r in enumerate(recs) if r["ok"] and pool is not None),
                  key=lambda i: -_expected_cost(cells[i]))
    jobs = []
    for i in todo:
        arch, shape_name, multi_pod, overrides, _ = cells[i]
        cfg = get_config(arch).replace(**overrides) if overrides else get_config(arch)
        ms = make_production_mesh(multi_pod=multi_pod)
        jobs.append((cfg, SHAPES[shape_name], ms.shape, ms.axis_names, None))
    pending = PendingCells(recs, todo, None, time.perf_counter())
    if jobs:
        pending.result = pool.map_async(
            _account_job, jobs, chunksize=1,
            callback=lambda _: pending.finished.append(time.perf_counter()))
    else:
        pending.finished.append(pending.started)
    return pending


def finish_cells(pending: PendingCells, out_dir: Path) -> list:
    """Wait for :func:`start_cells`'s execution, merge it into the records,
    write each to ``out_dir/<arch>__<shape>__<mesh>.json``; the records."""
    recs = pending.records
    if pending.result is not None:
        for i, res in zip(pending.todo, pending.result.get()):
            _merge(recs[i], res)
            recs[i]["total_s"] = round(recs[i]["total_s"] + res.get("run_s", 0.0), 3)
    out_dir.mkdir(parents=True, exist_ok=True)
    for rec in recs:
        out = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        out.write_text(json.dumps(rec, indent=1))
        status = "OK " if rec["ok"] else "FAIL"
        print(f"[{status}] {rec['arch']} × {rec['shape']} × {rec['mesh']} "
              f"({rec['total_s']}s)", flush=True)
        if not rec["ok"]:
            print(rec["error"], flush=True)
    return recs


def run_cells(cells: Sequence[tuple], out_dir: Path, execute: bool = True,
              workers: Optional[int] = None) -> list:
    """The records of ``(arch, shape_name, multi_pod[, overrides, variant])``
    cells (:func:`start_cells`, :func:`finish_cells`); with ``execute``,
    every cell that builds is executed in ``workers`` children."""
    if not execute:
        return finish_cells(start_cells(cells), out_dir)
    n = min(workers or os.cpu_count() or 1, 8, len(cells))
    with account_pool(n) as pool:
        return finish_cells(start_cells(cells, pool), out_dir)


def _expected_cost(cell: tuple) -> float:
    """A rough order of the cells' execution times: the op count grows with
    the layers and, for the chunked and scanned paths, with the tokens."""
    cfg, shape = get_config(cell[0]), SHAPES[cell[1]]
    loops = shape.seq_len if shape.kind != "decode" else 1
    return cfg.num_layers * loops * (3 if shape.kind == "train" else 1)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             overrides: dict | None = None, variant: str = "",
             execute: bool = True) -> dict:
    """One cell's record (:func:`run_cells`)."""
    return run_cells([(arch, shape_name, multi_pod, overrides or {}, variant)], out_dir,
                     execute, workers=1)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--variant", default="", help="suffix for A/B artifacts")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. decode_kv_expand=true")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.lstrip("-").isdigit() else v)
    rec = run_cell(args.arch, args.shape, args.multi_pod, Path(args.out),
                   overrides, args.variant)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Meta-device dry run of one (arch × shape × production mesh) cell (port of
``repro/launch/dryrun.py``).

For one cell: builds the production mesh (16x16 single pod / 2x16x16 multi
pod) as a :class:`MeshSpec`, assembles the cell under ``rules_for(kind,
cfg)`` (``launch/specs.build_cell``) with its arguments on the ``meta``
device, and accounts, per device: the arguments' bytes (params, plus opt
state or cache, plus batch; each leaf's bytes divided by the product of the
mesh sizes its spec names), the outputs' bytes, the parameter count and the
replicated / sharded parameter leaves, and whether the arguments fit the
card's HBM.  Nothing is allocated and no device is touched.

The reference's fields that only XLA's compiled HLO gives (``flops``,
``bytes_accessed``, ``collectives``, ``temp_bytes``, ``peak_bytes``,
``lower_s`` / ``compile_s``) are left out of the record (ROADMAP.md, Queue 1
item 8, what is left (3)).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--multi-pod] [--out build/dryrun]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

from ..configs.base import SHAPES
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


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             overrides: dict | None = None, variant: str = "") -> dict:
    from .specs import build_cell

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if variant:
        mesh_name = f"{mesh_name}__{variant}"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
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

    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    out.write_text(json.dumps(rec, indent=1))
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {arch} × {shape_name} × {mesh_name} ({rec['total_s']}s)", flush=True)
    if not rec["ok"]:
        print(rec["error"], flush=True)
    return rec


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

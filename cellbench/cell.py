"""One run of one cell: set-up, the measured window, the metrics, the
check.  ``run.py`` is the command; tests call :func:`run_cell` with
``device="cpu"`` and the smoke configurations.

Set-up (``setup_s``, from process start to the window's start): the CUDA
context, the port's kernels built (first run in a checkout) and loaded,
the weights drawn on the device, the traffic generated, a warm-up request
at the traffic's longest prompt through the engine (it sizes the pool),
the engine made, the traffic's prefixes registered and, for a backlog,
its lanes filled.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Optional

from . import check, costs, drive, weights
from .bench import Bench, read_metrics
from .traffic import generate

# the configuration file's published keys -> the port's ModelConfig fields
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
          "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size", "rope_theta": "rope_theta",
          "rms_norm_eps": "norm_eps", "sliding_window": "sliding_window",
          "num_local_experts": "num_experts", "num_experts_per_tok": "top_k",
          "tie_word_embeddings": "tie_embeddings", "torch_dtype": "compute_dtype"}

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# the profiled stretch: the window's last fifth, at most 8 s, so that the
# profiler's stop and the reading of its events fall after the window
TRACE_SHARE, TRACE_MAX_S = 0.2, 8.0


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    window: drive.Window
    flops: costs.ModelFlops
    tracer: object = None
    trace: object = None
    cuda: bool = True           # False: a CPU run, which reads no device metric


def forbidden_modules():
    """Top-level module names, compared whole, of the JAX side."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program_config(cfg: dict):
    """The port's ModelConfig of this configuration, with the file's
    overrides; refused where any published key disagrees with it."""
    from repro_torch.configs import registry

    p = cfg["program"]
    get = registry.get_smoke_config if p.get("preset") == "smoke" else registry.get_config
    mcfg = get(p["arch"]).replace(**p.get("overrides", {}))
    want = dict(cfg)
    want.setdefault("num_local_experts", 0)
    want.setdefault("num_experts_per_tok", 0)
    for key, field in FIELDS.items():
        if key in want and want[key] != getattr(mcfg, field):
            raise ValueError(f"{cfg['name']}: {key} is {want[key]!r} in the file, "
                             f"{getattr(mcfg, field)!r} in the port's config")
    if mcfg.head_dim * cfg["num_attention_heads"] != cfg["hidden_size"]:
        raise ValueError(f"{cfg['name']}: head_dim {mcfg.head_dim} is not hidden / heads")
    if mcfg.padded_heads != mcfg.num_heads or mcfg.padded_vocab != mcfg.vocab_size:
        raise ValueError(f"{cfg['name']}: padded heads or vocabulary; set the pad multiples")
    return mcfg


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _check_tree(ours, specs, where="params"):
    if isinstance(specs, dict):
        if not isinstance(ours, dict) or set(ours) != set(specs):
            raise ValueError(f"{where}: keys {sorted(ours)} against {sorted(specs)}")
        for k in specs:
            _check_tree(ours[k], specs[k], f"{where}.{k}")
    elif isinstance(specs, (list, tuple)):
        if len(ours) != len(specs):
            raise ValueError(f"{where}: {len(ours)} segments against {len(specs)}")
        for i, (a, b) in enumerate(zip(ours, specs)):
            _check_tree(a, b, f"{where}[{i}]")
    elif tuple(ours.shape) != tuple(specs.shape):
        raise ValueError(f"{where}: shape {tuple(ours.shape)} against {tuple(specs.shape)}")


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None, control: bool = False,
             mix_override: Optional[dict] = None, witness: Optional[dict] = None) -> dict:
    """One run; returns the result line's object (``checks`` last).  With
    ``control`` it also holds the float8 control, at the same positions,
    to the same limits (``out["control"]``: its readings, its checks and
    whether it came out correct); ``witness`` names further sets of the
    reference's routings to read both under (``check.judge``);
    ``mix_override`` replaces the traffic file's fields (the sweep's
    rates)."""
    import torch

    from repro_torch import kernels, torch_dtype
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    t_start = time.perf_counter() if t_start is None else t_start
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    mix = {**bench.mix(wl["traffic"]), **(mix_override or {})}
    limits = bench.limits(workload)
    mcfg = program_config(cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = torch_dtype(mcfg.compute_dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    if cuda:
        kernels.build_all()
        for name in kernels.SOURCES:
            kernels.load_library(name)
    params = weights.engine_params(cfg, seed, dtype, dev)
    _check_tree(params, T.param_specs(mcfg))
    traffic = generate.build(mix, seed, seconds, cfg["vocab_size"],
                             kinds_dir=bench.here / "traffic" / "kinds")
    pool = drive.size_pool(torch, ServeEngine, EngineConfig, Request, mcfg, params, cfg, mix,
                           traffic, dev, elt)
    engine = ServeEngine(mcfg, params, drive.engine_config(EngineConfig, mix, pool["num_pages"]),
                         device=dev)
    for p in traffic.prefixes:
        engine.register_prefix(p)
    warm = drive.start_warm_lanes(engine, Request, traffic) if traffic.warm else []
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    tracer = None
    if trace:
        from .tracing import Tracer
        tracer = Tracer(torch, engine, seconds - min(TRACE_SHARE * seconds, TRACE_MAX_S))
        tracer.warm()
    window = drive.run_window(engine, Request, traffic, seconds, warm, tracer)
    engine._settle_prefill_times(wait=True)
    sync()
    if tracer is not None:
        tracer.paged_lengths()
        tracer.engine = None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(window=window, flops=costs.ModelFlops(cfg), tracer=tracer,
              trace=tracer.result if tracer is not None else None, cuda=cuda)
    metrics = read_metrics(bench, workload, trace, run)
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    failed = sum(1 for r in window.reqs if r.req is not None and r.req.expired)
    page_b = drive.page_bytes(cfg, mix, elt)
    weights_b = tree_bytes(params)
    in_use = {"weights_bytes": weights_b, "peak_pages_used": window.stats1["peak_pages_used"],
              "page_bytes": page_b,
              "memory_in_use_bytes": weights_b + window.stats1["peak_pages_used"] * page_b}

    # the check, once the program's state is freed
    picked = check.sample(window.reqs, seed)
    served = [(r.item.prompt, list(r.req.generated)) for r in picked]
    del engine, params, warm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n_tokens = sum(len(g) for _, g in served)
    judged = {"program": {}, "control": {} if control else None, "reference_s": 0.0}
    if served:
        judged = check.judge(torch, cfg, seed, dtype, dev, served, control=control,
                             witness=witness)
    checks, correct = check.verdict(judged["program"], limits, n_tokens)

    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(window.reqs), "failed": failed,
           "metrics": metrics, "device": devinfo}
    if run.trace is not None:
        devinfo["busy_s"] = run.trace.busy_s
        devinfo["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    out["info"] = {"seed": seed, "seconds": seconds, "pool": pool, **in_use,
                   "reference_s": judged["reference_s"], "requests_checked": len(served),
                   "steps": len(window.steps),
                   "prefills": window.stats1["prefills"] - window.stats0["prefills"]}
    out["info"]["gaps"] = judged["program"]
    if control:
        c_checks, c_correct = check.verdict(judged["control"], limits, n_tokens)
        out["control"] = {"gaps": judged["control"], "checks": c_checks, "correct": c_correct}
    if witness:
        out["witness"] = {k: judged.get(k) for k in ("witness", "near_ties")}
    out["window"] = window
    if run.trace is not None:
        out["info"]["trace_kernels"] = run.trace.kernels
        out["info"]["trace_matched"] = run.trace.matched_kernels
    out["checks"] = checks
    return out

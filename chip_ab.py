#!/usr/bin/env python3
"""Parent / change / change / parent on one NVIDIA card: the serving
engine's end-to-end numbers of two checkouts of this repository, in turns.

    python3 chip_ab.py PARENT_ROOT CHANGE_ROOT     # each a checkout's root

Each turn is a fresh process that puts ``<root>/src`` first on the path,
builds that checkout's kernels (into ``<root>/build``) and runs, through
this directory's ``chip_smoke.py`` helpers:

* phase 3's serve run: full-width smollm-135m, bf16, random weights from
  seed 0, 16 launcher requests and a prefix request, after a 2-request
  warm-up;
* phase 6's long-prompt run: full-width qwen2-1.5b, bf16, 4 prompts of
  1-4 k tokens and one of 4096 whose first 4095 tokens are a registered
  prefix, x 16 new tokens, after a 4096-token warm-up request.

Each turn prints one JSON line: serve tok/s, the engine's prefill ms per
request, and host ms per install (each ``_install_pages`` call that writes,
timed on the host without a synchronise).  The last two lines are the
card's name and power limit from nvidia-smi and all four turns in one JSON
object.  Exits non-zero if a turn fails or there is no CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def one_turn(root: Path) -> dict:
    import torch

    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import chip_smoke as CS
    import repro_torch.models as M
    import repro_torch.serve.engine as engine_module
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import cast_params
    from repro_torch.serve.engine import EngineConfig, Request

    if root not in Path(M.__file__).resolve().parents:
        raise RuntimeError(f"repro_torch came from {M.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    K.build_all()
    out = {"root": str(root), "build_s": time.perf_counter() - t0}

    cfg = get_config("smollm-135m")
    params = M.init_params(cfg, seed=0, device="cuda")
    CS.serve(torch, cfg, params, 2, seed=7)                 # warm-up
    with CS.InstallTimer(engine_module) as installs:
        eng, _, seconds = CS.serve(torch, cfg, params, 16, seed=0)
    tokens = sum(len(r.generated) for r in eng.finished)
    out["serve"] = {"tok_per_s": tokens / seconds, "tokens": tokens, "seconds": seconds,
                    "install_host_ms": installs.summary()}
    del eng, params
    torch.cuda.empty_cache()

    cfg = get_config("qwen2-1.5b")
    params = cast_params(cfg, M.init_params(cfg, seed=0, device="cuda"))
    torch.cuda.empty_cache()
    ecfg = EngineConfig(**CS.LONG_ENGINE)
    warm = CS.long_prompt_requests(cfg, Request, seed=1, lens=[4096])
    warm[0].max_new_tokens = 2
    CS.serve_timed(torch, cfg, params, ecfg, warm)
    reqs = CS.long_prompt_requests(cfg, Request, seed=0)
    with CS.InstallTimer(engine_module) as installs:
        eng, seconds = CS.serve_timed(torch, cfg, params, ecfg, reqs,
                                      prefix=reqs[-1].prompt[:-1])
    done = sorted(eng.finished, key=lambda r: r.rid)
    out["long_prompt"] = {"prefill_ms": [[len(r.prompt) - 1, r.prefill_ms] for r in done],
                          "seconds": seconds, "install_host_ms": installs.summary()}
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--turn":
        print(json.dumps(one_turn(Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    parent, change = (Path(a).resolve() for a in argv[1:])
    turns = []
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", str(root)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
            return 1
        turn = {"turn": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

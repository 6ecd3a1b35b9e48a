"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

Port of ``repro/launch/train.py``, single device: builds the model from the
registry, streams batches from an int32 token shard through the UMap data
pipeline (``data/pipeline.py``), and runs the resident ``Trainer`` with
async checkpointing and restart.  Runs on the card by default; ``--device
cpu`` runs the plain PyTorch path (``--smoke`` picks the reduced config).
Weights are random, from ``--seed``.  Without ``--data`` a synthetic Zipf
shard is written to a temporary directory (removed at exit), as the JAX
package's launcher writes it.  Every architecture of the registry trains:
a stub-frontend one (qwen2-vl, seamless) takes random embeddings in place
of its frontend's output (:func:`stub_frontend`), where the JAX package's
launcher refuses it.  ``--dry`` runs the meta-device dry run of the
architecture's ``train_4k`` cell on the production mesh that ``--mesh``
names (``launch/dryrun.py``; a record in ``build/dryrun/``) and exits 0 if
it is ``ok``; ``--mesh`` alone changes nothing, as in the JAX package.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 100 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke \\
      --device cpu --steps 3 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --mesh single \\
      --dry   # per-device accounting of the production train step, no execution
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-feasible)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default=None, help="int32 token shard file")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi"], default=None,
                    help="production mesh of --dry: 16x16 (single) or 2x16x16 (multi)")
    ap.add_argument("--dry", action="store_true",
                    help="meta-device dry run of the production train step, then exit")
    return ap.parse_args(argv)


def write_synthetic_shard(path: Path, tokens: int, vocab_size: int) -> None:
    """Zipf-distributed int32 tokens over the first min(4096, vocab) ids,
    numpy seed 0 (the JAX package's synthetic shard)."""
    rng = np.random.default_rng(0)
    v_eff = min(4096, vocab_size)
    probs = 1.0 / np.arange(1, v_eff + 1)
    probs /= probs.sum()
    rng.choice(v_eff, size=tokens, p=probs).astype(np.int32).tofile(path)


def stub_frontend(cfg, batches, seed: int = 0):
    """Batches as a stub-frontend architecture takes them: qwen2-vl's patch
    embeddings and [B, 3, S] positions (all three rows the index) in place
    of the tokens; seamless's frame embeddings, as many frames as tokens,
    beside the decoder's tokens.  Embeddings are drawn from a numpy normal
    of ``seed`` (the JAX package stubs both frontends too); labels stay the
    shard's.  A token architecture's batches pass through."""
    if cfg.input_mode == "tokens" and not cfg.is_encdec:
        yield from batches
        return
    rng = np.random.default_rng(seed)
    for batch in batches:
        b, s = batch["labels"].shape
        out = dict(batch)
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        if cfg.is_encdec:
            out["src_embeds"] = emb
        else:
            del out["tokens"]
            out["embeds"] = emb
            if cfg.mrope_sections is not None:
                out["positions"] = np.broadcast_to(
                    np.arange(s, dtype=np.int32), (b, 3, s)).copy()
        yield out


def make_trainer(args: argparse.Namespace, shard: Path):
    """(trainer, loader, reader) as the launcher runs them: the Trainer for
    ``args`` and the pipeline's batches of ``args.batch`` x ``args.seq``
    from ``shard``.  The caller closes ``reader`` and the trainer."""
    from ..configs.registry import get_config, get_smoke_config
    from ..core import FileStore, UMapConfig
    from ..data.pipeline import lm_batches
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import TrainConfig
    from ..train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainerConfig(
        train=TrainConfig(optimizer=AdamWConfig(
            learning_rate=args.lr, warmup_steps=max(10, args.steps // 10),
            total_steps=args.steps), loss_chunk=min(1024, args.seq)),
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(10, args.steps // 4),
        log_every=max(1, args.steps // 20))
    trainer = Trainer(cfg, tcfg, seed=args.seed, device=args.device)
    loader, reader = lm_batches(
        FileStore(str(shard)), args.batch, args.seq,
        config=UMapConfig(page_size=1 << 20, buffer_size=32 << 20,
                          num_fillers=4, num_evictors=2, read_ahead=4,
                          eviction_policy="swa"))
    return trainer, stub_frontend(cfg, loader, args.seed), reader


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dry:
        from .dryrun import run_cell
        rec = run_cell(args.arch, "train_4k", args.mesh == "multi", Path("build/dryrun"))
        return 0 if rec["ok"] else 1

    from ..configs.registry import get_config, get_smoke_config

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tmp = None
    try:
        if args.data:
            shard = Path(args.data)
        else:
            tmp = Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
            shard = tmp / "tokens.bin"
            write_synthetic_shard(shard, args.steps * args.batch * (args.seq + 1) + 1024,
                                  cfg.vocab_size)
            print(f"synthetic shard: {shard}")
        trainer, loader, reader = make_trainer(args, shard)
        try:
            trainer.install_preemption_handler()
            if args.resume and trainer.try_resume():
                print(f"resumed from step {trainer.step}")
            result = trainer.fit(loader)
        finally:
            reader.close()
            trainer.close()
        for h in result["history"]:
            print(f"step {h['step']:6d} loss {h['loss']:.4f} "
                  f"gnorm {h['grad_norm']:.3f} {h['tokens_per_s']:.0f} tok/s")
        return 0
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())

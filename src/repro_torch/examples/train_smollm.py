"""End-to-end training driver: SmolLM-family model on an out-of-core token
shard, with async checkpointing and restart (port of the JAX package's
``examples/train_smollm.py``).

The default invocation trains a reduced SmolLM config for a few hundred steps
on synthetic data streamed through a UMap region (real demand paging +
readahead on the input path).  ``--full`` selects the true 135M
configuration.  Runs on the card by default; ``--device cpu`` runs the plain
PyTorch path.  Weights are random, from ``--seed``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_smollm [--steps 300]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..configs.registry import get_config, get_smoke_config
from ..core import FileStore, UMapConfig
from ..data.pipeline import lm_batches
from ..train.optimizer import AdamWConfig
from ..train.train_step import TrainConfig
from ..train.trainer import Trainer, TrainerConfig


def write_shard(path: Path, steps: int, batch: int, seq: int, vocab_size: int) -> None:
    """Enough synthetic int32 tokens for ``steps`` batches, numpy seed 0: a
    skewed unigram distribution (the model has something to learn) over the
    first min(256, vocab) ids."""
    rng = np.random.default_rng(0)
    need = steps * batch * (seq + 1) + 1024
    v_eff = min(256, vocab_size)          # stay inside the smoke vocab
    probs = 1.0 / np.arange(1, v_eff + 1)
    probs /= probs.sum()
    rng.choice(v_eff, size=need, p=probs).astype(np.int32).tofile(path)


def trainer_config(steps: int, seq: int, ckpt_dir: str) -> TrainerConfig:
    return TrainerConfig(
        train=TrainConfig(
            optimizer=AdamWConfig(learning_rate=3e-4, warmup_steps=20,
                                  total_steps=steps),
            loss_chunk=seq),
        total_steps=steps,
        ckpt_dir=ckpt_dir,
        ckpt_every=max(10, steps // 4),
        log_every=max(1, steps // 10),
    )


def shard_batches(shard: Path, batch: int, seq: int) -> tuple:
    """(loader, reader): ``lm_batches`` over ``shard`` through a UMap region."""
    return lm_batches(
        FileStore(str(shard)), batch, seq,
        config=UMapConfig(page_size=256 * 1024, buffer_size=4 << 20,
                          num_fillers=2, num_evictors=1, read_ahead=4,
                          eviction_policy="swa"))


def train(cfg, shard: Path, steps: int, batch: int, seq: int, ckpt_dir: str,
          device="cuda", seed: int = 0, params=None) -> dict:
    """Resume from ``ckpt_dir`` where it holds a checkpoint, then train to
    ``steps`` on ``shard``'s batches.  ``params``: a numpy tree in the JAX
    package's layout (else the port's seeded weights).  Returns ``fit``'s
    result with ``resumed``, ``resumed_step`` and the pipeline's stats."""
    trainer = Trainer(cfg, trainer_config(steps, seq, ckpt_dir), seed=seed, params=params,
                      device=device)
    loader, reader = shard_batches(shard, batch, seq)
    try:
        trainer.install_preemption_handler()
        resumed = trainer.try_resume()
        start = trainer.step
        result = trainer.fit(loader)
        stats = {k: v for k, v in reader.stats().items() if k != "per_filler_fills"}
    finally:
        reader.close()
        trainer.close()
    return {**result, "resumed": resumed, "resumed_step": start, "pipeline": stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="true 135M config instead of the reduced one")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (get_config("smollm-135m") if args.full
           else get_smoke_config("smollm-135m"))

    # ---- synthetic token shard on disk, streamed through a UMap region ----
    tmp = Path(tempfile.mkdtemp(prefix="smollm_data_"))
    try:
        shard = tmp / "tokens.bin"
        write_shard(shard, args.steps, args.batch, args.seq, cfg.vocab_size)
        # ---- trainer with async checkpoints + restart ----
        result = train(cfg, shard, args.steps, args.batch, args.seq,
                       args.ckpt_dir or str(tmp / "ckpt"), args.device, args.seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"resumed={result['resumed']} from step {result['resumed_step']}")
    print(f"finished at step {result['final_step']}")
    first = result["history"][0]["loss"]
    last = result["history"][-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({result['history'][-1]['tokens_per_s']:.0f} tok/s)")
    print("data-pipeline stats:", result["pipeline"])
    assert last < first, "model failed to learn"
    print("train_smollm OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

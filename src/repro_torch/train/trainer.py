"""Training loop: data pipeline -> step -> async checkpointing (port of
``repro/train/trainer.py``).

Fault-tolerance contract (DESIGN.md §4), as in the JAX package:
  * resume: picks up from the newest durable checkpoint (params + optimizer
    state + step);
  * async saves through ckpt.AsyncCheckpointer (watermark-bounded), which
    copies the state to the host before ``save_async`` returns;
  * preemption: ``request_stop`` (or SIGTERM from the launcher) triggers a
    final synchronous flush before exit.

The state lives on ``device`` (default ``"cuda"``, which raises without a
card; the tests pass ``"cpu"``).  ``params`` is an optional numpy tree in
the JAX package's layout (its ``init_params`` output, say); without it the
port's ``init_params(cfg, seed)`` draws the weights.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ckpt import checkpoint as ckpt
from ..configs.base import ModelConfig
from ..interop import params_from_numpy, tree_map
from ..models import transformer as T
from .optimizer import init_state
from .train_step import TrainConfig, train_step


@dataclasses.dataclass
class TrainerConfig:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            .to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, seed: int = 0,
                 params=None, device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.step = 0
        self.params = (params_from_numpy(params, self.device, cfg=cfg) if params is not None
                       else T.init_params(cfg, seed, device=self.device))
        self.opt_state = init_state(self.params)
        self._stop = False
        self.metrics_log: list = []
        self.ckptr = (ckpt.AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
                      if tcfg.ckpt_dir else None)

    # ------------------------------------------------------------- restart

    def state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state, "step": self.step}

    def try_resume(self) -> bool:
        if not self.tcfg.ckpt_dir:
            return False
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return False
        state = ckpt.restore(self.tcfg.ckpt_dir, step, self.state())
        upload = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)  # noqa: E731
        self.params = tree_map(upload, state["params"])
        self.opt_state = tree_map(upload, state["opt"])     # an AdamWState
        self.step = int(state["step"])
        return True

    def request_stop(self, *_) -> None:
        self._stop = True

    def install_preemption_handler(self) -> None:
        signal.signal(signal.SIGTERM, self.request_stop)

    # ----------------------------------------------------------------- run

    def fit(self, batches: Iterable[dict]) -> dict:
        t0 = time.time()
        tokens_done = 0
        for batch in batches:
            if self.step >= self.tcfg.total_steps or self._stop:
                break
            tbatch = to_device(batch, self.device)
            self.params, self.opt_state, metrics = train_step(
                self.cfg, self.tcfg.train, self.params, self.opt_state, tbatch)
            self.step += 1
            tokens_done += tbatch["labels"].numel()
            if self.step % self.tcfg.log_every == 0 or self.step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                m["tokens_per_s"] = tokens_done / max(1e-9, time.time() - t0)
                self.metrics_log.append(m)
            if self.ckptr and self.step % self.tcfg.ckpt_every == 0:
                self.ckptr.save_async(self.step, self.state())
        # final flush (preemption-safe exit)
        if self.ckptr:
            self.ckptr.save_async(self.step, self.state())
            self.ckptr.flush()
        return {
            "final_step": self.step,
            "loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "history": self.metrics_log,
        }

    def close(self) -> None:
        if self.ckptr is not None:
            self.ckptr.close()

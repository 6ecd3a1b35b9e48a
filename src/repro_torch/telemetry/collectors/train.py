"""Train collector: out-of-core trainer counters (DESIGN.md §18.6).

Wraps ONE ``train.ooc.OOCTrainer`` by duck-typing: its plain-dict
``stats`` counters (GIL-atomic int reads, the same relaxed contract as
the core pager's snapshot) plus derived state/buffer gauges.  The
underlying pager regions are expected to carry their own
``PagerCollector`` registrations; this collector covers only what the
training loop itself knows — steps, retries, sweep volume, the
zero-staging-copy invariant, and the oversubscription ratio.
"""

from __future__ import annotations

from typing import List

from ..metrics import MetricFamily
from .base import Collector

_TRAIN_COUNTERS = (
    ("steps", "umap_train_steps_total", "Optimizer steps completed"),
    ("step_retries", "umap_train_step_retries_total",
     "Sweep retries after a transient I/O fault"),
    ("io_errors", "umap_train_io_errors_total",
     "I/O errors surfaced to the training step (DESIGN.md §14.4)"),
    ("sweep_chunks", "umap_train_sweep_chunks_total",
     "Lease-run chunks applied by the optimizer sweep"),
    ("sweep_pages", "umap_train_sweep_pages_total",
     "Pages (params + moments) updated in place by the sweep"),
    ("ckpt_saves", "umap_train_ckpt_saves_total",
     "Checkpoints enqueued through the snapshot path (§18.4)"),
    ("quarantine_retries", "umap_train_quarantine_retries_total",
     "Quarantined pages re-posted by drain_quarantine (§17.4)"),
)


class TrainCollector(Collector):
    kind = "train"

    def __init__(self, trainer=None, label=None):
        super().__init__(label)
        self.trainer = trainer

    def collect(self) -> List[MetricFamily]:
        fams: List[MetricFamily] = []
        if self.trainer is None:
            return fams
        tr = self.trainer
        st = dict(tr.stats)
        fams += [self.c1(m, h, st.get(k, 0)) for k, m, h in _TRAIN_COUNTERS]
        fams += [
            self.c1("umap_train_staging_copies_total",
                    "Copy-backed lease grants on the training path "
                    "(0 == zero-copy contract held)", tr.staging_copies),
            self.g1("umap_train_state_bytes",
                    "Packed params + moments bytes behind the regions",
                    tr.state_bytes()),
            self.g1("umap_train_buffer_bytes",
                    "Combined page-buffer bytes serving the state",
                    tr.buffer_bytes()),
            self.g1("umap_train_oversubscription_ratio",
                    "state_bytes / buffer_bytes (>1 == out-of-core)",
                    tr.oversubscription()),
            self.g1("umap_train_step", "Current optimizer step",
                    tr.step_no),
            self.g1("umap_train_last_step_seconds",
                    "Wall-clock duration of the most recent step",
                    st.get("last_step_s", 0.0)),
        ]
        return fams

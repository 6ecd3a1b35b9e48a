"""Out-of-core training-data pipeline over UMap regions.

Token shards live on disk (or any BackingStore); the pipeline reads batches
*through the paging core* with deep readahead (AccessAdvice.STREAMING -> SWA
eviction: forward-moving, no reuse), then double-buffers host->device
transfers.  This is the paper's out-of-core story applied to the training
input path: a slow shard (remote store, straggler disk) hides behind the
readahead window instead of stalling the step loop (DESIGN.md §4).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..core import (
    AccessAdvice,
    BackingStore,
    PagingService,
    UMapConfig,
    apply_advice,
    umap,
)


class TokenShardReader:
    """Sequential epoch reader over an int32 token shard via a UMap region."""

    def __init__(self, store: BackingStore, batch_tokens: int,
                 config: Optional[UMapConfig] = None,
                 service: Optional[PagingService] = None):
        cfg = config or UMapConfig(
            page_size=1 << 20, buffer_size=64 << 20, num_fillers=4,
            num_evictors=2)
        cfg = apply_advice(cfg, AccessAdvice.STREAMING)
        self.region = umap(store, config=None if service else cfg,
                           service=service)
        self.batch_tokens = batch_tokens
        self.total_tokens = store.size // 4
        self._pos = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if (self._pos + self.batch_tokens) * 4 > self.region.size:
            raise StopIteration
        raw = self.region.read(self._pos * 4, self.batch_tokens * 4)
        self._pos += self.batch_tokens
        return raw.view(np.int32)

    def reset(self) -> None:
        self._pos = 0

    def stats(self) -> dict:
        return self.region.stats()

    def close(self) -> None:
        self.region.close()


class DoubleBufferedLoader:
    """Prefetch thread + bounded queue: batch p+1 loads while p trains.

    The producer thread is a UMap *filler* one level up: it absorbs storage
    latency jitter (straggler mitigation at the input layer).
    """

    def __init__(self, reader, make_batch, depth: int = 2):
        self.reader = reader
        self.make_batch = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        try:
            for raw in self.reader:
                self._q.put(self.make_batch(raw))
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def lm_batches(store: BackingStore, batch_size: int, seq_len: int,
               config: Optional[UMapConfig] = None,
               depth: int = 2):
    """Yield {"tokens", "labels"} next-token batches from a token shard."""
    reader = TokenShardReader(store, batch_size * (seq_len + 1), config)

    def make(raw: np.ndarray) -> dict:
        arr = raw.reshape(batch_size, seq_len + 1)
        return {"tokens": arr[:, :-1].copy(), "labels": arr[:, 1:].copy()}

    return DoubleBufferedLoader(reader, make, depth), reader

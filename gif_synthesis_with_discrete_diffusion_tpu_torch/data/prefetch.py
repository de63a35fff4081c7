"""Background batch prefetching.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/data/prefetch.py``
(the same batches in the same order): a small thread pool decodes and
collates items ahead of the training loop (cv2's decode releases the GIL,
so threads suffice, and the uint8 batches are small: preprocessing runs on
the device inside the step), and a daemon thread buffers whole batches.

Wrap any datamodule: ``PrefetchingDataModule(dm, num_workers=4, depth=2)``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

__all__ = ["PrefetchingDataModule", "prefetch_iterator"]

_SENTINEL = object()


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a daemon thread, buffering up to `depth` items."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put(e)
            return
        q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


class _ParallelBatches:
    """Decode items with a thread pool, preserving batch order."""

    def __init__(self, dm, num_workers: int):
        self._dm = dm
        self._n = num_workers

    def __call__(self, split: str, shuffle: bool, epoch: int):
        import numpy as np
        from concurrent.futures import ThreadPoolExecutor

        from .synthetic import collate

        items = self._dm._items(split)
        order = np.arange(len(items))
        if shuffle:
            np.random.default_rng(self._dm.seed + 1000 + epoch).shuffle(order)
        bs, rows = self._dm.batch_size, self._dm.batch_rows()
        starts = range(0, len(order) - bs + 1, bs)
        with ThreadPoolExecutor(max_workers=self._n) as pool:
            def make_batch(s):
                return collate([self._dm._get(split, int(j)) for j in
                                order[s + rows.start:s + rows.stop]])
            yield from pool.map(make_batch, starts)


class PrefetchingDataModule:
    """Wraps a datamodule: threaded item decode + batch-ahead buffering."""

    def __init__(self, dm, num_workers: int = 4, depth: int = 2):
        self._dm = dm
        self._depth = depth
        self._parallel = (_ParallelBatches(dm, num_workers)
                          if num_workers > 0 and hasattr(dm, "_get")
                          else None)

    def __getattr__(self, name):
        return getattr(self._dm, name)

    def _wrap(self, split: str, shuffle: bool, epoch: int, fallback):
        if (split == "test" and hasattr(self._dm, "_has_split")
                and not self._dm._has_split("test")):
            split = "val"  # file-backed dms fall back to val (no test dir)
        if self._parallel is not None:
            it = self._parallel(split, shuffle, epoch)
        else:
            it = fallback(epoch)
        return prefetch_iterator(it, self._depth)

    def train_batches(self, epoch: int = 0):
        return self._wrap("train", True, epoch, self._dm.train_batches)

    def val_batches(self, epoch: int = 0):
        return self._wrap("val", False, epoch, self._dm.val_batches)

    def test_batches(self, epoch: int = 0):
        return self._wrap("test", False, epoch, self._dm.test_batches)

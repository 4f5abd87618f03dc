"""Batched host loader, port of ``stereoscene_tpu/data/loader.py``.

Worker threads run the numpy pipeline and the batches come out in order,
stacked into numpy arrays. A pipeline whose ``__call__`` takes ``seed`` gets
one per sample, derived from (loader seed, epoch, sample index) as the JAX
package derives it, so augmentation draws do not depend on thread
scheduling and equal the JAX loader's. A worker's exception is raised in the
consumer.
"""

from __future__ import annotations

import concurrent.futures
import inspect
from typing import Callable, Dict, Iterator, List

import numpy as np


def _accepts_seed(pipeline: Callable) -> bool:
    try:
        sig = inspect.signature(
            pipeline.__call__ if not inspect.isfunction(pipeline) else pipeline)
    except (TypeError, ValueError):
        return False
    return "seed" in sig.parameters


class BatchLoader:
    """``frames`` through ``pipeline`` in batches of ``batch_size``, on
    ``num_workers`` threads with up to ``prefetch`` batches ahead of the
    consumer; ``drop_last`` drops a short tail batch."""

    def __init__(
        self,
        frames: List,
        pipeline: Callable,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        self.frames = frames
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.epoch = 0
        self._pipeline_takes_seed = _accepts_seed(pipeline)

    def __len__(self):
        n = len(self.frames)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.frames))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def _batch(self, idxs, epoch: int) -> Dict[str, np.ndarray]:
        if self._pipeline_takes_seed:
            samples = [
                self.pipeline(self.frames[j], seed=(
                    self.seed * 1000003 + epoch * 131071 + int(j))
                    % (2**31 - 1))
                for j in idxs]
        else:
            samples = [self.pipeline(self.frames[j]) for j in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        epoch = self.epoch
        self.epoch += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        ahead = self.num_workers + self.prefetch
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = [pool.submit(self._batch, b, epoch)
                       for b in batches[:ahead]]
            for i in range(len(batches)):
                batch = pending[i].result()
                pending[i] = None
                if i + ahead < len(batches):
                    pending.append(pool.submit(self._batch,
                                               batches[i + ahead], epoch))
                yield batch

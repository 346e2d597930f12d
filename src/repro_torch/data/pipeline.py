"""Host-side data pipeline (port of ``repro/data/pipeline.py``): batching,
device placement, prefetch, resume.

``DataPipeline`` wraps an epoch-iterator dataset and feeds device batches;
``to_device`` takes the place of the JAX ``shard_batch`` (one device, no
shardings).  One-deep prefetch overlaps host generation with device compute;
the producer thread stops when the consumer does, and an error in the
dataset is raised in the consumer.

Exact-order resume: ``epoch(e, skip=n)`` drops the first ``n`` host batches
of epoch ``e`` before any device placement, so a run resuming at global
step ``s`` consumes exactly the batches an uninterrupted run would have seen
from step ``s`` on.  ``steps_per_epoch`` (when the dataset knows it) lets
``locate`` jump straight to ``(s // steps_per_epoch, s % steps_per_epoch)``;
otherwise ``count_epoch`` walks an epoch host-side.
"""
from __future__ import annotations

import collections
import itertools
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def to_device(batch: dict, device=None) -> dict:
    """Each numpy array of ``batch`` as a tensor on ``device`` (CPU by
    default); integer arrays become int64, the index dtype of torch."""
    out = {}
    for k, x in batch.items():
        a = np.asarray(x)
        t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)
        out[k] = t.to(device) if device is not None else t
    return out


class DataPipeline:
    def __init__(self, epoch_fn: Callable[[int], Iterator[dict]], device=None,
                 prefetch: int = 1, steps_per_epoch: Optional[int] = None):
        self.epoch_fn = epoch_fn
        self.device = device
        self.prefetch = prefetch
        self.steps_per_epoch = steps_per_epoch

    def count_epoch(self, epoch_idx: int) -> int:
        """Number of batches epoch ``epoch_idx`` yields."""
        if self.steps_per_epoch is not None:
            return self.steps_per_epoch
        return sum(1 for _ in self.epoch_fn(epoch_idx))

    def locate(self, global_step: int):
        """(epoch, batches-to-skip) positioning ``global_step`` in the
        epoch stream — the exact-data-order resume arithmetic."""
        if global_step <= 0:
            return 0, 0
        if self.steps_per_epoch:
            return divmod(global_step, self.steps_per_epoch)
        epoch, remaining = 0, global_step
        while True:
            n = self.count_epoch(epoch)
            if n <= 0:
                raise RuntimeError(
                    f"cannot locate step {global_step} for resume: epoch "
                    f"{epoch} yields no batches (after skipping "
                    f"{global_step - remaining})")
            if remaining < n:
                return epoch, remaining
            remaining -= n
            epoch += 1

    def epoch(self, epoch_idx: int, skip: int = 0) -> Iterator[dict]:
        it = self.epoch_fn(epoch_idx)
        if skip:
            it = itertools.islice(it, skip, None)
        if self.prefetch <= 0:
            for b in it:
                yield to_device(b, self.device)
            return
        q: collections.deque = collections.deque()
        done = object()
        ev, stop = threading.Event(), threading.Event()

        def fill():
            try:
                for b in it:
                    while len(q) > self.prefetch and not stop.is_set():
                        ev.wait(0.001)
                    if stop.is_set():
                        return
                    q.append(to_device(b, self.device))
                q.append(done)
            except BaseException as e:   # handed to the consumer, raised there
                q.append(e)

        threading.Thread(target=fill, daemon=True).start()
        try:
            while True:
                if not q:
                    ev.wait(0.0005)
                    ev.clear()
                    continue
                item = q.popleft()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:    # a consumer that stops early also stops the producer
            stop.set()

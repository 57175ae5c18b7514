"""Host-side batch loader with background prefetch.

The port's copy of ``biom3_tpu/data/loader.py:19-89`` (numpy and a thread).
It replaces the reference's ``torch.utils.data.DataLoader(num_workers=12)``
stack: a thread pipelines host batch assembly (tokenization, indexing) ahead
of device consumption so the device is never input-bound.  Device
transfer happens on the consumer side, keeping this loader
framework-agnostic.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class BatchLoader:
    """Iterate index-batches through ``make_batch`` with N prefetched ahead."""

    def __init__(
        self,
        num_examples: int,
        batch_size: int,
        make_batch: Callable[[np.ndarray], dict],
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.num_examples = num_examples
        self.batch_size = batch_size
        self.make_batch = make_batch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0
        if len(self) == 0:
            raise ValueError(
                f"batch_size {batch_size} > dataset size {num_examples} with "
                "drop_last=True would yield zero batches"
            )

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_examples // self.batch_size
        return -(-self.num_examples // self.batch_size)

    def _index_batches(self) -> list[np.ndarray]:
        idx = np.arange(self.num_examples)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        stop = (
            len(self) * self.batch_size if self.drop_last else self.num_examples
        )
        return [
            idx[i : i + self.batch_size]
            for i in range(0, stop, self.batch_size)
        ]

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()

        def producer():
            try:
                for b in batches:
                    q.put(self.make_batch(b))
                q.put(_SENTINEL)
            except BaseException as e:  # surface in the consumer, don't hang
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
        t.join()

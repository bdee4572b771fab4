"""Threaded prefetching data loader with bucket batching.

Replaces mmdet's ``build_dataloader`` (worker processes + GroupSampler,
SURVEY.md L2): a deterministic per-epoch shuffle, aspect-ratio bucket
grouping (so every batch has ONE static padded shape -> one jit
executable per bucket), worker threads decoding/augmenting ahead of the
accelerator, and per-host sharding for multi-host data parallelism
(``jax.process_index``-strided, the TPU replacement for
DistributedGroupSampler).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["TrainLoader"]


def _stack(dicts: list[dict]) -> dict:
    out = {}
    for k in dicts[0]:
        if k == "bucket":
            continue
        vals = [d[k] for d in dicts]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class TrainLoader:
    """Iterates (epoch-bounded) batches of augmented samples.

    Batches are homogeneous in bucket; the iterator yields
    ``dict(img, gt_points, gt_labels, gt_valid, img_wh)`` numpy batches.
    """

    def __init__(
        self,
        dataset,
        pipeline,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        num_threads: int = 4,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        # per-host strided shard (deterministic across hosts)
        return idx[self.process_index :: self.process_count]

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield one epoch of batches, prefetched by worker threads."""
        indices = self._epoch_indices(epoch)
        work: "queue.Queue[int | None]" = queue.Queue()
        done: "queue.Queue[tuple[int, dict] | None]" = queue.Queue(self.prefetch * self.batch_size)
        for i in indices:
            work.put(int(i))
        for _ in range(self.num_threads):
            work.put(None)

        def worker(tid: int):
            while True:
                i = work.get()
                if i is None:
                    done.put(None)
                    return
                rng = np.random.RandomState((self.seed, epoch, i))
                try:
                    out = self.pipeline(self.dataset[i], rng)
                except Exception as e:  # surface loader errors, don't hang
                    done.put(("error", e))
                    return
                done.put((i, out))

        threads = [
            threading.Thread(target=worker, args=(t,), daemon=True)
            for t in range(self.num_threads)
        ]
        for t in threads:
            t.start()

        buckets: dict[str, list[dict]] = {}
        finished = 0
        received = 0
        total = len(indices)
        while received < total and finished < self.num_threads:
            item = done.get()
            if item is None:
                finished += 1
                continue
            if item[0] == "error":
                raise item[1]
            _, sample = item
            received += 1
            b = sample["bucket"]
            buckets.setdefault(b, []).append(sample)
            if len(buckets[b]) == self.batch_size:
                yield _stack(buckets.pop(b))
        if not self.drop_last:
            for group in buckets.values():
                if group:
                    while len(group) < self.batch_size:  # repeat-pad tail
                        group.append(group[-1])
                    yield _stack(group)

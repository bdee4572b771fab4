"""Threaded prefetching data loader with bucket batching.

Replaces mmdet's ``build_dataloader`` (worker processes + GroupSampler,
SURVEY.md L2): a deterministic per-epoch shuffle, aspect-ratio bucket
grouping (so every batch has ONE static padded shape -> one jit
executable per bucket), worker threads decoding/augmenting ahead of the
accelerator, and per-rank sharding for data parallelism (strided by
``process_index`` of ``process_count``, the DistributedGroupSampler's
job). A consumer that leaves an epoch early stops its worker threads.

Every rank yields the same number of batches in an epoch: a data-parallel
train step is a collective, so a rank with one step more would pair its
all-reduces with another rank's next step. Each rank fills its own
buckets, and shards of one size can fill different numbers of batches, so
every rank counts, from the dataset's image sizes, what each shard fills
(``steps_per_epoch``) and stops at the fewest.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["TrainLoader"]


def _image_size(dataset, i: int) -> tuple[int, int] | None:
    """(w, h) of sample ``i``'s source image: the annotation file's, else
    the image file's header; None for a dataset without ``samples``."""
    samples = getattr(dataset, "samples", None)
    if not samples:
        return None
    s = samples[i % len(samples)]
    if s.width and s.height:
        return int(s.width), int(s.height)
    from PIL import Image

    with Image.open(s.img_path) as im:
        return im.size


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

    def _epoch_indices(self, epoch: int, rank: int | None = None) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        # per-host strided shard (deterministic across hosts)
        rank = self.process_index if rank is None else rank
        return idx[rank :: self.process_count]

    @functools.cached_property
    def _buckets(self) -> list | None:
        """Each sample's bucket from its image size, or None where the
        pipeline cannot tell it before loading."""
        of = getattr(self.pipeline, "bucket_of_size", None)
        sizes = [_image_size(self.dataset, i) for i in range(len(self.dataset))]
        buckets = [None if of is None or wh is None else of(*wh) for wh in sizes]
        return None if None in buckets else buckets

    def _batches(self, indices, buckets) -> int:
        """Batches that the samples ``indices`` fill, each bucket apart."""
        b = self.batch_size
        return sum(n // b if self.drop_last else -(-n // b)
                   for n in collections.Counter(buckets[i] for i in indices).values())

    def steps_per_epoch(self, epoch: int = 0) -> int:
        """Batches that ``epoch(epoch)`` yields on every rank: the fewest
        that any rank's shard fills. Raises under several ranks when the
        samples' buckets are not known before loading (a crop)."""
        buckets = self._buckets
        if buckets is None:
            if self.process_count > 1:
                raise NotImplementedError(
                    "TrainLoader: several ranks need each sample's bucket before it is loaded "
                    "(the dataset's image sizes, and no crop) to agree on a step count")
            n = len(self._epoch_indices(epoch))
            return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return min(self._batches(self._epoch_indices(epoch, r), buckets)
                   for r in range(self.process_count))

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield one epoch of batches, prefetched by worker threads; under
        several ranks, ``steps_per_epoch(epoch)`` of them."""
        indices = self._epoch_indices(epoch)
        ranks = self.process_count > 1
        limit = self.steps_per_epoch(epoch) if ranks else None
        buckets = self._buckets if ranks else None
        work: "queue.Queue[int | None]" = queue.Queue()
        done: "queue.Queue[tuple[int, dict] | None]" = queue.Queue(self.prefetch * self.batch_size)
        for i in indices:
            work.put(int(i))
        for _ in range(self.num_threads):
            work.put(None)

        stop = threading.Event()

        def worker(tid: int):
            while True:
                i = work.get()
                if i is None or stop.is_set():
                    done.put(None)
                    return
                rng = np.random.RandomState((self.seed, epoch, i))
                try:
                    out = self.pipeline(self.dataset[i], rng)
                except Exception as e:  # surface loader errors, don't hang
                    done.put(("error", e))
                    done.put(None)
                    return
                done.put((i, out))

        threads = [
            threading.Thread(target=worker, args=(t,), daemon=True)
            for t in range(self.num_threads)
        ]
        for t in threads:
            t.start()

        groups: dict[str, list[dict]] = {}
        finished = 0
        received = 0
        yielded = 0
        total = len(indices)
        try:
            while received < total and finished < self.num_threads and yielded != limit:
                item = done.get()
                if item is None:
                    finished += 1
                    continue
                if item[0] == "error":
                    raise item[1]
                i, sample = item
                received += 1
                b = sample["bucket"]
                if ranks and b != buckets[i]:
                    raise RuntimeError(f"TrainLoader: sample {i} landed in bucket {b}, its image "
                                       f"size says {buckets[i]}: the ranks' step counts would "
                                       f"differ")
                groups.setdefault(b, []).append(sample)
                if len(groups[b]) == self.batch_size:
                    yielded += 1
                    yield _stack(groups.pop(b))
        finally:
            # a consumer that leaves the epoch early (a step limit) stops the
            # workers: they take no new index, and the queue is drained until
            # each has put its last item
            stop.set()
            while finished < self.num_threads:
                if done.get() is None:
                    finished += 1
        if not self.drop_last:
            for group in groups.values():
                if group and yielded != limit:
                    while len(group) < self.batch_size:  # repeat-pad tail
                        group.append(group[-1])
                    yielded += 1
                    yield _stack(group)

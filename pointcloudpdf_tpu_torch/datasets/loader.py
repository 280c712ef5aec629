# Copied from pointcloudpdf_tpu/datasets/loader.py (Subset, DataLoader and
# MultiDatasetDataloader); keep in step.
"""Host-side batch loader with deterministic sharding and prefetch.

Replaces torch's DataLoader + DistributedSampler stack
(reference engines/train.py:229-258): a seeded per-epoch shuffle, an even
shard per process (multi-host DP), thread-pool sample preparation, and a
small prefetch queue that overlaps host data work with device steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np


class Subset:
    """A fixed index view over a dataset (torch.utils.data.Subset parity,
    used by OpenSegTrainer's train_subsampling_ratio, reference
    engines/train.py:428-436)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def __getattr__(self, name):
        # transparent passthrough for dataset attributes (class names,
        # split metadata) that hooks/testers read off the train set
        return getattr(self.dataset, name)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Callable = None,
        num_workers: int = 0,
        seed: Optional[int] = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        prefetch: int = 2,
    ):
        assert collate_fn is not None, "collate_fn is required"
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.seed = seed if seed is not None else 0
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.prefetch = max(prefetch, 1)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reseed the shuffle per epoch (DistributedSampler.set_epoch parity)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % (2**31))
            rng.shuffle(order)
        if self.num_shards > 1:
            # even shards: pad by wrapping so every shard sees the same count
            per_shard = -(-n // self.num_shards)
            padded = np.concatenate([order, order[: per_shard * self.num_shards - n]])
            order = padded[self.shard_id :: self.num_shards]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        idx = self._indices()
        limit = (
            len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
        )
        for start in range(0, limit, self.batch_size):
            yield idx[start : start + self.batch_size]

    def _prepare(self, batch_idx) -> dict:
        samples = [self.dataset[int(i)] for i in batch_idx]
        return self.collate_fn(samples)

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers <= 0:
            for batch_idx in self._batches():
                yield self._prepare(batch_idx)
            return

        # thread-pool prefetch pipeline: futures submitted ahead of use
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending = []
                for batch_idx in self._batches():
                    if stop.is_set():
                        break
                    pending.append(pool.submit(self._prepare, batch_idx))
                    while len(pending) >= self.prefetch:
                        out_q.put(pending.pop(0))
                for fut in pending:
                    if stop.is_set():
                        break
                    out_q.put(fut)
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                fut = out_q.get()
                if fut is None:
                    break
                yield fut.result()
        finally:
            stop.set()
            # drain so the producer can exit
            while True:
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break


class MultiDatasetDataloader:
    """Batches from one sub-dataset at a time, mixed by loop ratios.

    Reference: pointcept/datasets/dataloader.py:23-112 — each sub-dataset's
    ``loop`` is its sampling ratio (reset to 1 after reading); the overall
    epoch length follows the main (first) dataset times the concat loop.
    Every yielded batch carries a single dataset's samples, so the
    per-dataset ``condition`` key stays uniform within a batch.

    Over several shards every sub-loader has the same length on every
    shard (``DataLoader`` pads a shard by wrapping), so every rank takes
    the same sub-dataset at the same step and a sub-loader runs out on all
    ranks at once: ``lengths`` is what a trainer compares across ranks.
    """

    def __init__(self, concat_dataset, batch_size=1, collate_fn=None,
                 num_workers=0, seed=0, shard_id=0, num_shards=1):
        self.datasets = concat_dataset.datasets
        self.ratios = [int(getattr(d, "loop", 1)) for d in self.datasets]
        for d in self.datasets:
            d.loop = 1
        self.datasets[0].loop = getattr(concat_dataset, "loop", 1)
        self.loaders = [
            DataLoader(
                d, batch_size=batch_size, shuffle=True, drop_last=True,
                collate_fn=collate_fn, num_workers=num_workers,
                seed=(seed or 0) + i, shard_id=shard_id,
                num_shards=num_shards,
            )
            for i, d in enumerate(self.datasets)
        ]
        self.batch_size = batch_size

    def set_epoch(self, epoch: int):
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def lengths(self):
        """Each sub-loader's batches an epoch on this shard."""
        return [len(loader) for loader in self.loaders]

    def __len__(self):
        # main dataset drives the epoch; others contribute by ratio
        main = len(self.loaders[0])
        per_cycle = self.ratios[0]
        cycles = max(main // max(per_cycle, 1), 1)
        return sum(
            min(cycles * r, len(ld)) if i else main
            for i, (r, ld) in enumerate(zip(self.ratios, self.loaders))
        )

    def __iter__(self):
        iters = [iter(ld) for ld in self.loaders]
        main_remaining = len(self.loaders[0])
        while main_remaining > 0:
            for i, ratio in enumerate(self.ratios):
                take = min(ratio, main_remaining) if i == 0 else ratio
                for _ in range(take):
                    try:
                        yield next(iters[i])
                    except StopIteration:
                        if i == 0:
                            return
                        continue
                    if i == 0:
                        main_remaining -= 1

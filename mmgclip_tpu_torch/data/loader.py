"""Batch iteration over datasets (port of mmgclip_tpu/data/loader.py).

Replaces torch DataLoader workers (reference: mmgclip/dataset/dataloaders.py)
with a synchronous numpy loader: with text pre-tokenized and features held in
one contiguous bank (see datasets.py), collate is pure array indexing —
worker processes would only add IPC overhead.  Shuffling uses an explicit
seeded Generator re-derived per epoch so runs replay exactly.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

from .sampler import ImbalancedDatasetSampler


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        shuffle: bool = True,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        sampler: Optional[ImbalancedDatasetSampler] = None,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or getattr(dataset, "collate_fn", None)
        self.sampler = sampler
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        # with a sampler the per-class remainder is dropped, so count its
        # actual yield, not len(dataset)
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.sampler is not None:
            return np.fromiter(iter(self.sampler), np.int64)
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self._epoch)).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator:
        indices = self._indices()
        # advance the epoch as soon as iteration STARTS (not on generator
        # exhaustion): a caller that breaks early — step caps, islice — must
        # not silently replay the identical shuffle order next epoch.  Full
        # iterations see the same per-epoch orders as before (epoch k's
        # permutation is still keyed (seed, k))
        self._epoch += 1
        n = len(indices)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            chunk = indices[start : start + self.batch_size]
            items = [self.dataset[int(i)] for i in chunk]
            yield self.collate_fn(items) if self.collate_fn else items


class DataLoaders:
    """Factory with the reference's constructor shape
    (reference: dataloaders.py:6-40)."""

    def __init__(self, config, dataset_split):
        self.config = config
        self.dataset_split = dataset_split

    def get_dataloader(
        self,
        shuffle: bool = True,
        batch_size: int = 32,
        drop_last: bool = False,
        pin_memory: bool = False,  # accepted for config compat; batches are numpy
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,  # accepted for config compat; loader is sync
        prefetch_factor: int = 0,
        label_class_name: str = "image_description",
        use_sampler: bool = False,
    ) -> DataLoader:
        seed = int(self.config.base.seed)
        sampler = (
            ImbalancedDatasetSampler(self.dataset_split, class_name=label_class_name, seed=seed)
            if use_sampler
            else None
        )
        return DataLoader(
            self.dataset_split,
            batch_size=batch_size,
            shuffle=shuffle,
            drop_last=drop_last,
            collate_fn=collate_fn,
            sampler=sampler,
            seed=seed,
        )


def dataloader_percentage(dataloader: DataLoader, config, collate_fn=None) -> DataLoader:
    """Rebuild a loader over a random subset (data-efficiency experiments,
    reference: dataloaders.py:42-57)."""
    from .split import Subset

    fraction = float(config.dataset.percentage.config.percentage)
    n = len(dataloader.dataset)
    keep = int(n * fraction)
    rng = np.random.default_rng(int(config.base.seed))
    indices = rng.permutation(n)[:keep]
    subset = Subset(dataloader.dataset, indices)
    return DataLoader(
        subset,
        batch_size=dataloader.batch_size,
        shuffle=True,
        drop_last=dataloader.drop_last,
        collate_fn=collate_fn or dataloader.collate_fn,
        seed=int(config.base.seed),
    )

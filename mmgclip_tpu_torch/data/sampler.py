"""Class-balanced sampling (port of mmgclip_tpu/data/sampler.py; reference:
mmgclip/dataset/datasampler.py:6-58).

Round-robin sampling-with-replacement from per-class index pools, keyed on any
batch field (default ``image_description``).  Uses an explicit numpy Generator
instead of global numpy state.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..utils.logging import logger


class ImbalancedDatasetSampler:
    def __init__(self, dataset, class_name: str = "image_description", seed: int = 0):
        logger.info("Using a sampler for handling class imbalance.")
        self.class_name = class_name
        self.num_samples = len(dataset)
        self._rng = np.random.default_rng(seed)

        labels = np.asarray([dataset[i][class_name] for i in range(len(dataset))], dtype=object)
        unique, counts = np.unique(labels, return_counts=True)
        order = np.argsort(-counts)  # most frequent first (value_counts order)
        self.class_indices = [np.where(labels == unique[i])[0] for i in order]
        # NOTE: no per-sample weights — unlike the reference's
        # WeightedRandomSampler shape, sampling is uniform WITHIN each class
        # pool and round-robin ACROSS classes, which is the same
        # class-balanced marginal (reference: datasampler.py:52-56)

    def __iter__(self) -> Iterator[int]:
        # one draw per class up front (O(n) RNG work), then round-robin —
        # same iid-uniform-per-class distribution and interleaving as the
        # reference's per-round redraws (reference: datasampler.py:52-56,
        # which draws size=per_class each round and takes one)
        per_class = self.num_samples // len(self.class_indices)
        picks = [
            self._rng.choice(indices, size=per_class, replace=True)
            for indices in self.class_indices
        ]
        for i in range(per_class):
            for class_picks in picks:
                yield int(class_picks[i])

    def __len__(self) -> int:
        # the TRUE yield count: per-class remainder is dropped by the
        # round-robin, so n - (n % k), not n
        per_class = self.num_samples // len(self.class_indices)
        return per_class * len(self.class_indices)

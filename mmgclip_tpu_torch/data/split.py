"""Seeded dataset splitting (port of mmgclip_tpu/data/split.py).

The reference replays splits purely from the saved seed
(reference: dataset.py:75-88, evaluate_clip.py:51-61): training and every
later evaluation derive identical train/val/test partitions by re-running the
same seeded split.  This module keeps that contract with a numpy-based
permutation (deterministic across processes and platforms, unlike torch's
generator) and a lightweight Subset view.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class Subset:
    """A view over a dataset (or another Subset) through an index list."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]

    @property
    def collate_fn(self):
        return self.dataset.collate_fn


def seeded_split(n: int, train_ratio: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Permute [0, n) with `seed`; first `int(ratio*n)` are the train side."""
    train_size = int(train_ratio * n)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[:train_size], perm[train_size:]


def random_split(dataset, ratio: float, seed: int) -> Tuple[Subset, Subset]:
    left_idx, right_idx = seeded_split(len(dataset), ratio, seed)
    return Subset(dataset, left_idx), Subset(dataset, right_idx)

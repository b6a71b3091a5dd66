"""Seeded weights and token rows for the DeepSeek-V3 text tower, made on the
device.  The weights are the reference's own draw (``reference/deepseek_v3.py``:
each tensor by its HF name), rounded to what the program holds."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference.deepseek_v3 import draw, shapes


def tree(t: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The program's weights: every tensor under its HF name, bfloat16 (the
    selection bias float32), on ``device``."""
    out = {}
    for name, shape in shapes(t):
        x = draw(seed, name, shape, t, device)
        out[name] = x if name.endswith("e_score_correction_bias") else x.to(torch.bfloat16)
    return out


def parameter_count(t: Dict) -> int:
    return sum(math.prod(shape) for _name, shape in shapes(t))


def lengths(rng: np.random.Generator, n: int, spec: Dict) -> np.ndarray:
    """Valid lengths: log-normal around ``median`` with ``sigma``, rounded
    and clipped to [``min``, ``max``]."""
    raw = np.exp(rng.normal(math.log(spec["median"]), spec["sigma"], size=n))
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


class ZipfIds:
    """Ids of a vocabulary drawn by rank with probability ~ rank^-s, the
    ranks given to ids by a permutation drawn from the seed."""

    def __init__(self, seed: int, vocab: int, s: float):
        self.ids = np.random.default_rng([int(seed), 22]).permutation(vocab)
        weights = np.arange(1, vocab + 1, dtype=np.float64) ** -float(s)
        self.cdf = np.cumsum(weights / weights.sum())

    def __call__(self, rng: np.random.Generator, n: int) -> np.ndarray:
        ranks = np.searchsorted(self.cdf, rng.random(n), side="right")
        return self.ids[np.minimum(ranks, len(self.ids) - 1)]


def sweep_rows(seed: int, sweep: int, traffic: Dict, ids: ZipfIds):
    """Sweep ``sweep``'s report rows and image features, distinct from every
    other sweep's: -> (input_ids [n, L] int32, attention_mask [n, L] int32,
    features [n, feature_dim] float32), right-padded with id 0."""
    rng = np.random.default_rng([int(seed), 21, int(sweep)])
    n, width = int(traffic["rows_per_sweep"]), int(traffic["sequence_length"])
    lens = lengths(rng, n, traffic["lengths"])
    mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.int32)
    input_ids = np.zeros((n, width), np.int32)
    input_ids[mask > 0] = ids(rng, int(lens.sum()))
    features = rng.normal(size=(n, int(traffic["feature_dim"]))).astype(np.float32)
    return input_ids, mask, features

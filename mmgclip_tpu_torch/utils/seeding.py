"""Deterministic seeding (port of mmgclip_tpu/utils/seeding.py).

Randomness goes through explicit generators: ``random.Random`` and a numpy
``Generator`` on the host, a ``torch.Generator`` for tensors (the JAX
package's ``jax_key``; the two frameworks give different numbers from one
seed, so tests make shared inputs with numpy).  ``seeding()`` also seeds the
global stdlib, numpy and torch state for scripts that rely on it.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Rngs:
    """Explicit per-concern RNG handles derived from one seed."""

    seed: int

    @property
    def host(self) -> random.Random:
        return random.Random(self.seed)

    @property
    def numpy(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    def torch_generator(self, device="cpu") -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.seed)


def seeding(seed: int) -> Rngs:
    """Seed the global host and torch RNG state and return explicit handles."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return Rngs(seed)


def create_directory_if_not_exists(path: str) -> str:
    if path is None:
        raise ValueError("Invalid path passed.")
    os.makedirs(path, exist_ok=True)
    return str(path)

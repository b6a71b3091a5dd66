"""Seeded full-field mammogram phantoms and the PNG files made from them.

A phantom is a [H, W] uint16 image: a half-ellipse of tissue against the
chest wall (left or right, drawn from the seed) on a zero background, whose
share of the image is the traffic's ``tissue_share``.  Tissue is 12-bit
(``bits``): a smooth density field over the breast, brighter towards the
chest wall, with fine texture on top.  Every phantom of a set has the same
size and the same tissue share, so two seeds give the same amount of work.
Image ``i`` of seed ``s`` depends on ``(s, i)`` alone.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from .png16 import write_png16

_GRID = (18, 15)  # the coarse density grid, upsampled bilinearly


def _upsample(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] linear interpolation weights."""
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.floor(pos).astype(int).clip(0, n_in - 2)
    frac = pos - lo
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] = 1.0 - frac
    m[np.arange(n_out), lo + 1] = frac
    return m


def phantom(seed: int, index: int, height: int, width: int, tissue_share: float = 0.55,
            bits: int = 12) -> np.ndarray:
    rng = np.random.default_rng([int(seed), int(index)])
    top = (1 << bits) - 1
    # half-ellipse against the chest wall: area (pi / 4) * sa * sb of the image
    sb = 0.96
    sa = min(tissue_share * 4.0 / np.pi / sb, 1.0)
    y = (np.arange(height, dtype=np.float32) - 0.5 * height) / (0.5 * height * sb)
    x = np.arange(width, dtype=np.float32) / (width * sa)
    if rng.random() < 0.5:  # laterality: the chest wall on the right
        x = x[::-1].copy()
    r2 = x[None, :] ** 2 + y[:, None] ** 2
    inside = r2 <= 1.0
    coarse = rng.normal(size=_GRID).astype(np.float32)
    field = _upsample(height, _GRID[0]) @ coarse @ _upsample(width, _GRID[1]).T
    density = 0.45 * top + 0.12 * top * field + 0.25 * top * (1.0 - np.minimum(x[None, :], 1.0))
    density -= 0.2 * top * np.clip(r2 - 0.85, 0.0, None) / 0.15  # skin-line falloff
    texture = rng.normal(scale=0.01 * top, size=(height, width)).astype(np.float32)
    tissue = np.clip(density + texture, 1.0, top)
    return np.where(inside, tissue, 0.0).round().astype(np.uint16)


def image_path(root: str, index: int) -> str:
    """The file of image ``index`` under ``root``, in the dataset's
    ``2D_100micron/`` layout the feature store mirrors."""
    return os.path.join(root, "2D_100micron", f"{index:05d}", f"{index:05d}_CC.png")


def write_phantoms(root: str, seed: int, count: int, height: int, width: int,
                   tissue_share: float, bits: int, level: int, threads: int = 8) -> List[str]:
    """Write ``count`` phantom PNGs under ``root``; returns their paths in order."""
    def one(i: int) -> str:
        path = image_path(root, i)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png16(path, phantom(seed, i, height, width, tissue_share, bits), level)
        return path

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, range(count)))

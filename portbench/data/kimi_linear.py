"""Seeded weights for the Kimi-Linear text tower, made on the device: the
reference's own draw (``reference/kimi_linear.py``: each tensor by its HF
name), rounded to what the program holds.  Token rows are the DeepSeek-V3
bank's (``data/deepseek_v3.py``: log-normal lengths, Zipf ids)."""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.kimi_linear import FLOAT32, draw, shapes
from .deepseek_v3 import ZipfIds, sweep_rows  # noqa: F401  (the cell's rows)


def tree(t: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The program's weights: every tensor under its HF name, bfloat16
    (``A_log``, ``dt_bias`` and the selection bias float32), on ``device``."""
    out = {}
    for name, shape in shapes(t):
        x = draw(seed, name, shape, t, device)
        out[name] = x if name.endswith(FLOAT32) else x.to(torch.bfloat16)
    return out


def parameter_count(t: Dict) -> int:
    return sum(math.prod(shape) for _name, shape in shapes(t))

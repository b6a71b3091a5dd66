"""Ops of the port: plain PyTorch math and the hand-written CUDA kernels.

Each kernel wrapper adds one to its launch count where it launches its kernel
and nowhere else, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

from typing import Dict

_LAUNCHES: Dict[str, int] = {"fused_convnext_block": 0, "flash_attention": 0}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0

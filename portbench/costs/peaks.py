"""Data-sheet peaks (dense, no sparsity) of the cards the benchmark runs on,
under the name ``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM5 (80 GB HBM3): 989 TFLOP/s bf16 / fp16, 495 TF32, 67 fp32
outside the tensor cores, 1,979 TOP/s int8 / fp8, 3.35 TB/s HBM, at the
700 W power limit.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12,
                              "int8": 1979e12, "fp8": 1979e12, "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> Optional[dict]:
    """The card's peaks, or None for a card without an entry."""
    return PEAKS.get(device_name)

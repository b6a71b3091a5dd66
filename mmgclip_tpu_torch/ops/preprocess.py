"""Device-side image intensity preprocessing (port of mmgclip_tpu/ops/preprocess.py).

The reference decodes 8-bit PNGs on the host, multiplies by 65535 to restore
the 16-bit DICOM range, then normalizes (x - 32767.5) / 32767.5.  Here the
chain runs on the device on raw uint8/uint16 pixels, so the host-to-device
copy carries 1-2 bytes per pixel:

    to_16bit -> normalize_16bit(window=...)
"""

from __future__ import annotations

import torch

_SCALE_8 = 257.0  # 8-bit pixels: ToTensor() scales p/255, then *65535 => 257*p
_CENTER = 32767.5


def to_16bit(pixels: torch.Tensor) -> torch.Tensor:
    """uint8/uint16/float pixels -> fp32 in the 16-bit intensity domain."""
    if pixels.dtype == torch.uint8:
        return pixels.to(torch.float32) * _SCALE_8
    if pixels.dtype == torch.uint16:
        return pixels.to(torch.float32)
    # already-float inputs are assumed ToTensor-style [0, 1]
    return pixels.to(torch.float32) * 65535.0


def normalize_16bit(x: torch.Tensor, out_dtype=torch.float32, window=None) -> torch.Tensor:
    """fp32 16-bit-domain intensities -> normalized [-1, 1].

    ``window=(center, width)`` maps [center - width/2, center + width/2] onto
    [-1, 1] and clips outside, with a true division so the full-range window
    equals the reference affine byte for byte."""
    if window is not None:
        center, width = float(window[0]), float(window[1])
        if width <= 0:
            raise ValueError(f"window width must be positive, got {width}")
        y = (x - center) / (width * 0.5)
        return torch.clamp(y, -1.0, 1.0).to(out_dtype)
    return ((x - _CENTER) / _CENTER).to(out_dtype)


def intensity_transform(pixels: torch.Tensor, out_dtype=torch.float32, window=None) -> torch.Tensor:
    """uint8/uint16 pixels -> normalized [-1, 1] float, reference-equivalent."""
    return normalize_16bit(to_16bit(pixels), out_dtype=out_dtype, window=window)

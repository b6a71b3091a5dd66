"""A 16-bit grayscale PNG writer with adaptive-style Paeth filtering.

Every scanline carries filter type 4 (Paeth), the filter that adaptive
encoders pick for most rows of a smooth medical image, and the stream is
deflated with ``zlib`` at the given level (6 is zlib's and libpng's default).
The filter runs over the whole image at once in numpy: encoding predicts from
the unfiltered neighbours, so no row waits for the one above.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def paeth_filter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """[rows, stride] uint8 scanlines -> their Paeth residuals (uint8)."""
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def png16_bytes(pixels: np.ndarray, level: int = 6) -> bytes:
    """[H, W] uint16 -> the bytes of a 16-bit grayscale PNG."""
    if pixels.dtype != np.uint16 or pixels.ndim != 2:
        raise ValueError(f"expected a [H, W] uint16 array, got {pixels.dtype} {pixels.shape}")
    height, width = pixels.shape
    raw = pixels.astype(">u2").view(np.uint8).reshape(height, 2 * width)
    rows = np.empty((height, 2 * width + 1), np.uint8)
    rows[:, 0] = 4  # Paeth
    rows[:, 1:] = paeth_filter(raw, 2)
    header = struct.pack(">IIBBBBB", width, height, 16, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png16(path: str, pixels: np.ndarray, level: int = 6) -> int:
    """Write ``pixels`` to ``path``; returns the file's size in bytes."""
    data = png16_bytes(pixels, level)
    with open(path, "wb") as fh:
        fh.write(data)
    return len(data)

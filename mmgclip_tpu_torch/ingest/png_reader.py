"""PNG decoding on the standard library's ``zlib`` and numpy.

Port of mmgclip_tpu/ingest/png_reader.py without its native libpng shim and
PIL fallback, neither of which the card's machine has.  It decodes what
mammograms and the test fixtures are: non-interlaced grayscale PNGs of 8 or
16 bits, with all five row filters.  Any other colour type, bit depth or an
interlaced file raises ``ValueError`` (ROADMAP.md lists the gap).

Rows filtered with Sub and Up are undone with numpy; Average and Paeth rows
carry a left-neighbour dependency and run as a Python loop over the row,
which is slow on full-field mammograms that use them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG has no IEND chunk")


def _unfilter_loop(kind: int, cur: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows, in place."""
    n = len(cur)
    if kind == 3:
        for i in range(n):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        return
    for i in range(n):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    filters = rows[:, 0]
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(filters[y])
        line = rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: running sum per byte lane, modulo 256
            lanes = line.astype(np.int64).reshape(-1, bpp) if stride % bpp == 0 else None
            if lanes is None:
                raise ValueError("PNG row length is not a whole number of pixels")
            out[y] = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev  # uint8 arithmetic wraps modulo 256
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            _unfilter_loop(kind, cur, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        prev = out[y]
    return out


def decode_png(path: str) -> np.ndarray:
    """Decode a grayscale PNG to an [H, W] uint8 or uint16 array."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path!r} is not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    width, height, depth, color, _compression, _filter, interlace = header
    if color != 0 or depth not in (8, 16) or interlace != 0:
        raise ValueError(
            f"{path!r}: only non-interlaced 8/16-bit grayscale PNGs are decoded "
            f"by the PyTorch port (colour type {color}, bit depth {depth}, "
            f"interlace {interlace}); see ROADMAP.md")
    bpp = depth // 8
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 8:
        return pixels.reshape(height, width)
    return pixels.reshape(height, width * 2).view(">u2").astype(np.uint16)

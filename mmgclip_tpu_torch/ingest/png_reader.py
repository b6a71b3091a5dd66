"""PNG decoding on the standard library's ``zlib``, numpy and a compiled unfilter.

Port of mmgclip_tpu/ingest/png_reader.py without its native libpng shim and
PIL fallback, neither of which the card's machine has.  It returns what the
shim returns (native/png_decode.cc): a grayscale [H, W] array, uint16 for
16-bit files and uint8 otherwise, for every colour type, bit depth and
interlace method of the PNG standard:

* gray of 1, 2 or 4 bits is expanded to 8 bits (x255, x85, x17);
* palette entries become RGB, then gray;
* RGB becomes gray with libpng's fixed-point weights for red 0.299 and
  green 0.587 (``png_set_rgb_to_gray_fixed(png, 1, 29900, 58700)``): 15-bit
  coefficients 9797 / 19234 / 3737, truncated at 8 bits and rounded at 16;
* alpha (from the colour type or a tRNS chunk) is dropped;
* Adam7 interlacing is undone.

Inflate is the standard library's ``zlib``.  ``decode_png`` undoes the row
filters on the host by a compiled C function (``csrc/png_unfilter.c``, built
by ``cc`` into ``mmgclip_tpu_torch/_build/`` at first use and called through
ctypes, which releases the GIL, so decode threads run in parallel).  A
missing compiler or a failed build raises.  ``_unfilter`` is the plain numpy
/ Python version the tests hold it against; no decode path uses it.

``read_png_rows`` stops after inflate for the files whose rows the card can
unfilter (``ops/png_unfilter.py``): non-interlaced grayscale of 8 or 16
bits, the full-field mammograms.  It returns their filtered scanlines
(``FilteredRows``: a read-only ``[H, 1 + stride]`` view of zlib's output,
with no copy and no byte swap) after the checks ``decode_png`` makes (CRCs,
header, data length, and every row's filter byte), so a bad file raises the
same ``ValueError`` on the decode thread.  Every other file (Adam7, palette,
RGB, gray + alpha, 1-, 2- and 4-bit gray) it decodes with ``decode_png``.
The feature store's encoder (``ingest/encode.py::_Encoder``) calls it where
its batches go to the card unchanged; serving, reports and every host path
call ``decode_png``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import NamedTuple, Union

import numpy as np

from ..ops import _build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# libpng's rgb_to_gray coefficients out of 32768 for (29900, 58700) / 100000
_RC, _GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC
_SOURCE = "png_unfilter.c"
_SIGNATURES = {"mmg_png_unfilter": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}


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


def _unfilter(raw: memoryview, height: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (a filter byte + ``stride`` bytes each) -> [height, stride]
    (the plain version of ``unfilter``)."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: running sum per byte lane, modulo 256
            lanes = line.astype(np.int64).reshape(-1, bpp)
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


def unfilter(data: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """The compiled unfilter: filtered scanlines at the start of the writable
    uint8 array ``data`` (a filter byte + ``stride`` bytes each) are undone in
    place -> a [height, stride] view of the raw bytes."""
    if data.dtype != np.uint8 or data.ndim != 1 or not data.flags.writeable \
            or not data.flags.c_contiguous:
        raise ValueError("unfilter needs a writable contiguous 1-D uint8 array")
    if data.size < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = data[:height * (stride + 1)].reshape(height, stride + 1)
    lib = _build.load_typed(_SOURCE, _SIGNATURES)
    bad = lib.mmg_png_unfilter(height, stride, bpp, rows.ctypes.data)
    if bad:
        raise ValueError(f"unknown PNG row filter {int(rows[bad - 1, 0])}")
    return rows[:, 1:]


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> [h, width, channels] samples (uint16 at 16 bits,
    uint8 otherwise; sub-byte samples unpacked MSB first, not yet scaled)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :width * channels].reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # MSB first
    unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, rows.shape[1] * per_byte)[:, :width].reshape(h, width, 1)


def _decode_samples(data: np.ndarray, width: int, height: int, channels: int, depth: int,
                    interlace: int) -> np.ndarray:
    """Inflated image data (a writable uint8 array, unfiltered in place) ->
    [height, width, channels] samples."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    if interlace == 0:
        stride = (width * bits + 7) // 8
        return _samples(unfilter(data, height, stride, bpp), width, channels, depth)
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = (width - x0 + dx - 1) // dx if width > x0 else 0
        ph = (height - y0 + dy - 1) // dy if height > y0 else 0
        if pw == 0 or ph == 0:
            continue  # an empty pass has no scanlines at all
        stride = (pw * bits + 7) // 8
        rows = unfilter(data[pos:], ph, stride, bpp)
        pos += ph * (stride + 1)
        out[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    return out


def _rgb_to_gray(rgb: np.ndarray, depth: int) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    total = _RC * r + _GC * g + _BC * b
    if depth == 16:
        return ((total + 16384) >> 15).astype(np.uint16)
    return (total >> 15).astype(np.uint8)


class FilteredRows(NamedTuple):
    """A grayscale image's filtered scanlines, as ``read_png_rows`` hands
    them over: ``rows`` [H, 1 + W * depth // 8] uint8 (filter byte first),
    ``depth`` 8 or 16 bits."""

    rows: np.ndarray
    depth: int

    @property
    def shape(self):
        """The pixels' [H, W]."""
        return self.rows.shape[0], (self.rows.shape[1] - 1) * 8 // self.depth


def _read(path: str):
    """-> (header fields, palette or None, the inflated image data as bytes)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path!r} is not a PNG file")
    header, palette = None, None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    _width, _height, depth, color, _compression, _filter, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or interlace not in (0, 1):
        raise ValueError(f"{path!r}: invalid PNG header (colour type {color}, bit depth "
                         f"{depth}, interlace {interlace})")
    return header, palette, zlib.decompress(b"".join(idat))


def read_png_rows(path: str) -> Union[FilteredRows, np.ndarray]:
    """A non-interlaced 8- or 16-bit grayscale PNG -> its ``FilteredRows``,
    checked as ``decode_png`` checks them; any other PNG -> ``decode_png``'s
    pixels (module docstring)."""
    header, palette, data = _read(path)
    width, height, depth, color, _compression, _filter, interlace = header
    if color != 0 or depth not in (8, 16) or interlace != 0:
        return _pixels(path, header, palette, data)
    pitch = 1 + width * depth // 8
    if len(data) < height * pitch:
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(data, np.uint8, count=height * pitch).reshape(height, pitch)
    bad = np.flatnonzero(rows[:, 0] > 4)
    if bad.size:
        raise ValueError(f"unknown PNG row filter {int(rows[bad[0], 0])}")
    return FilteredRows(rows, depth)


def decode_png(path: str) -> np.ndarray:
    """Decode a PNG to a grayscale [H, W] array (uint16 for 16-bit files,
    uint8 otherwise), with the values of the JAX package's native reader."""
    return _pixels(path, *_read(path))


def _pixels(path: str, header, palette, data: bytes) -> np.ndarray:
    width, height, depth, color, _compression, _filter, interlace = header
    data = np.frombuffer(bytearray(data), np.uint8)
    samples = _decode_samples(data, width, height, _CHANNELS[color], depth, interlace)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path!r}: palette image without a PLTE chunk")
        index = samples[..., 0]
        if index.max(initial=0) >= len(palette):
            raise ValueError(f"{path!r}: palette index out of range")
        return _rgb_to_gray(palette[index], 8)
    if color in (2, 6):
        return _rgb_to_gray(samples, depth)
    gray = samples[..., 0]  # gray, or gray + alpha with the alpha dropped
    if depth < 8:
        gray = (gray * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return np.ascontiguousarray(gray)

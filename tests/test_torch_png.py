"""The port's PNG reader against the JAX package's (its native libpng shim).

A numpy + zlib writer makes every colour type and bit depth of the PNG
standard, with and without Adam7 interlacing, rows filtered with random
filter types 0-4, palettes and tRNS chunks; the port's ``decode_png`` must
return the JAX ``decode_png``'s array bit for bit.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from mmgclip_tpu.ingest import png_reader as jax_png
from mmgclip_tpu_torch.ingest.png_reader import decode_png
from torch_shims import load_jax_shim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.fixture(scope="module")
def jax_decode():
    """The JAX reader with its native shim (built from native/ if absent;
    ``torch_shims.load_jax_shim`` waits out builds in other test processes)."""
    if load_jax_shim(jax_png, "libmmg_png.so") is None:
        pytest.skip("the JAX package's native PNG shim cannot be built here")
    return jax_png.decode_png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(raw: np.ndarray, bpp: int, rng) -> bytes:
    """[h, stride] uint8 scanlines -> filtered bytes, a random filter per row."""
    out = []
    prev = np.zeros(raw.shape[1], np.int64)
    for row in raw.astype(np.int64):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = int(rng.integers(0, 5))
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][kind]
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] samples -> [h, stride] packed big-endian scanlines."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    per_byte = 8 // depth
    flat = samples.reshape(h, w).astype(np.uint8)
    flat = np.pad(flat, ((0, 0), (0, (-w) % per_byte)))
    groups = flat.reshape(h, -1, per_byte)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(groups << shifts, axis=2).astype(np.uint8)


def write_png(path, samples, color, depth, interlace, rng, palette=None, trns=None):
    h, w, _ch = samples.shape
    bpp = max(1, CHANNELS[color] * depth // 8)
    if interlace:
        data = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                data += filter_rows(pack_rows(sub, depth), bpp, rng)
    else:
        data = filter_rows(pack_rows(samples, depth), bpp, rng)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    parts = [b"\x89PNG\r\n\x1a\n",
             chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))]
    if palette is not None:
        parts.append(chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    if trns is not None:
        parts.append(chunk(b"tRNS", trns))
    # two IDAT chunks: the stream may be split anywhere
    comp = zlib.compress(data, 6)
    parts += [chunk(b"IDAT", comp[: len(comp) // 2]), chunk(b"IDAT", comp[len(comp) // 2:]),
              chunk(b"IEND", b"")]
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))


def make_case(path, color, depth, interlace, trns, h=13, w=11, seed=0):
    rng = np.random.default_rng(seed + 100 * color + depth + 1000 * interlace + 7 * trns)
    ch = CHANNELS[color]
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, size=(h, w, ch))
    if color in (2, 6):  # some exactly gray pixels too
        samples[::3, ::2, 1] = samples[::3, ::2, 0]
        samples[::3, ::2, 2] = samples[::3, ::2, 0]
    palette, trns_body = None, None
    if color == 3:
        n = min(top + 1, 1 + int(samples.max()))
        palette = rng.integers(0, 256, size=(n, 3))
        if trns:
            trns_body = bytes(rng.integers(0, 256, size=n).astype(np.uint8))
    elif trns and color == 0:
        trns_body = struct.pack(">H", int(samples[0, 0, 0]))
    elif trns and color == 2:
        trns_body = struct.pack(">HHH", *(int(v) for v in samples[0, 0]))
    write_png(path, samples, color, depth, interlace, rng, palette, trns_body)


@pytest.mark.parametrize("color,depth", CASES)
@pytest.mark.parametrize("interlace", [0, 1])
def test_decode_equals_the_jax_reader(tmp_path, jax_decode, color, depth, interlace):
    for trns in ((0, 1) if color in (0, 2, 3) else (0,)):
        path = str(tmp_path / f"c{color}_d{depth}_i{interlace}_t{trns}.png")
        make_case(path, color, depth, interlace, trns)
        ref = jax_decode(path)
        out = decode_png(path)
        assert out.dtype == ref.dtype and out.shape == ref.shape == (13, 11)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (3, 5), (8, 8), (17, 23)])
def test_interlaced_odd_sizes_with_empty_passes(tmp_path, jax_decode, hw):
    path = str(tmp_path / "odd.png")
    make_case(path, 0, 16, 1, 0, h=hw[0], w=hw[1], seed=3)
    np.testing.assert_array_equal(decode_png(path), jax_decode(path))


def test_corrupt_file_raises(tmp_path):
    path = str(tmp_path / "bad.png")
    make_case(path, 0, 8, 0, 0)
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF  # inside the first IDAT: fails its CRC
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        decode_png(path)

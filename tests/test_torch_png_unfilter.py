"""The compiled PNG unfilter (``csrc/png_unfilter.c``) against its plain
version, filter type by filter type.

Random raw scanlines are filtered with one filter type forced on every row
(and with a random type per row), at every bytes-per-pixel the PNG standard
has and at odd widths (7 and 29 pixels, one pixel); ``png_reader.unfilter``
(compiled, in place) must return what ``png_reader._unfilter`` (numpy and a
Python loop) returns, bit for bit.  An unknown filter byte raises the plain
version's ``ValueError``; a missing compiler or a failed build raises
``RuntimeError`` and nothing drops back to the plain version.
"""

import os
import shutil

import numpy as np
import pytest

from mmgclip_tpu_torch.ingest import png_reader
from mmgclip_tpu_torch.ops import _build

BPPS = (1, 2, 3, 4, 6, 8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered(raw: np.ndarray, bpp: int, kinds) -> bytes:
    """[h, stride] raw bytes -> filtered scanlines, row y with filter kinds[y]."""
    out = []
    prev = np.zeros(raw.shape[1], np.int64)
    for row, kind in zip(raw.astype(np.int64), kinds):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:len(row)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(row)]
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][kind]
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def both(data: bytes, height: int, stride: int, bpp: int):
    plain = png_reader._unfilter(memoryview(data), height, stride, bpp)
    compiled = png_reader.unfilter(np.frombuffer(bytearray(data), np.uint8), height, stride, bpp)
    return plain, compiled


@pytest.mark.parametrize("bpp", BPPS)
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_compiled_equals_plain(kind, bpp):
    rng = np.random.default_rng(bpp * 10 + (5 if kind == "mixed" else kind))
    height, stride = 9, (29 if bpp == 1 else 7) * bpp  # odd widths
    raw = rng.integers(0, 256, size=(height, stride), dtype=np.uint8)
    raw[2] = 255  # saturated rows: Average's left + up overflows a byte
    raw[3] = 0
    kinds = rng.integers(0, 5, size=height) if kind == "mixed" else [kind] * height
    plain, compiled = both(filtered(raw, bpp, kinds), height, stride, bpp)
    np.testing.assert_array_equal(plain, raw)
    assert compiled.shape == (height, stride)
    np.testing.assert_array_equal(compiled, plain)


@pytest.mark.parametrize("bpp", [1, 2, 8])
def test_rows_of_one_pixel(bpp):
    """stride == bpp (an Adam7 pass one pixel wide): no byte has a left neighbour."""
    rng = np.random.default_rng(bpp)
    raw = rng.integers(0, 256, size=(6, bpp), dtype=np.uint8)
    plain, compiled = both(filtered(raw, bpp, [4, 3, 1, 2, 4, 3]), 6, bpp, bpp)
    np.testing.assert_array_equal(compiled, plain)
    np.testing.assert_array_equal(compiled, raw)


def test_unknown_filter_byte_raises():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(4, 12), dtype=np.uint8)
    data = bytearray(filtered(raw, 2, [4, 4, 4, 4]))
    data[2 * 13] = 7  # row 2's filter byte
    with pytest.raises(ValueError, match="unknown PNG row filter 7"):
        png_reader._unfilter(memoryview(bytes(data)), 4, 12, 2)
    with pytest.raises(ValueError, match="unknown PNG row filter 7"):
        png_reader.unfilter(np.frombuffer(data, np.uint8), 4, 12, 2)


def test_short_data_raises():
    with pytest.raises(ValueError, match="shorter than its header"):
        png_reader.unfilter(np.zeros(10, np.uint8), 2, 5, 1)


def test_decode_never_runs_the_plain_version(tmp_path, monkeypatch):
    import chip_smoke

    pixels = chip_smoke.synthetic_mammogram(37, 29, seed=1)
    path = str(tmp_path / "paeth.png")
    chip_smoke.write_png16(path, pixels, paeth=True)

    def refuse(*_args):
        raise AssertionError("the plain unfilter ran on a decode path")

    monkeypatch.setattr(png_reader, "_unfilter", refuse)
    monkeypatch.setattr(png_reader, "_unfilter_loop", refuse)
    np.testing.assert_array_equal(png_reader.decode_png(path), pixels)


def _fresh_build(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})


def test_missing_compiler_raises(tmp_path, monkeypatch):
    _fresh_build(tmp_path, monkeypatch)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        png_reader.unfilter(np.zeros(8, np.uint8), 1, 7, 1)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    _fresh_build(tmp_path, monkeypatch)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "png_unfilter.c").write_text("int mmg_png_unfilter(int h) { return h }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    with pytest.raises(RuntimeError, match="failed on png_unfilter.c") as err:
        png_reader.unfilter(np.zeros(8, np.uint8), 1, 7, 1)
    assert "error" in str(err.value)
    assert os.listdir(tmp_path / "build") == []  # no half-written library is left

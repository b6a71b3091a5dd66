"""The hand-off of filtered rows to the card, on the CPU.

* Routing by header: ``png_reader.read_png_rows`` hands over the filtered
  scanlines of non-interlaced 8- and 16-bit grayscale PNGs (a read-only
  view of zlib's output, the file's own bytes) and decodes every other file
  (Adam7, palette, RGB, gray + alpha, 1-, 2- and 4-bit gray) to
  ``decode_png``'s pixels.
* The skip-and-log contract on the hand-off path: an unknown filter byte
  and data shorter than the header says raise ``decode_png``'s
  ``ValueError`` on the decode thread; ``_Encoder._safe_decode`` logs the
  file to ``failed.txt`` and returns None.
* ``ops/png_unfilter.py``'s plain PyTorch version against the host's plain
  ``png_reader._unfilter`` (and the reader's byte swap), bit for bit: each
  filter type forced and a type drawn per row, 8 and 16 bits, odd widths,
  one-pixel rows, saturated rows; zero pad images give zeros.
* The encoder: the card route taken only where the program takes the raw
  pixel batch on cards (``_unfilters_on_card``); forced on the CPU (the
  plain version stands in for the kernel) its features are bit-equal to the
  host route's, over one device and two; every ``encode.decode`` span says
  where its rows were unfiltered.
"""

import os
import struct
import threading
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from mmgclip_tpu_torch.config import Config, compose
from mmgclip_tpu_torch.ingest import png_reader
from mmgclip_tpu_torch.ingest.encode import _Encoder
from mmgclip_tpu_torch.ops.png_unfilter import plain_png_unfilter, png_unfilter
from mmgclip_tpu_torch.utils import profiling
from test_torch_png import CASES, make_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [torch.profiler.ProfilerActivity.CPU]


def write_gray(path, rows: np.ndarray, width: int, depth: int, data: bytes = None) -> None:
    """A non-interlaced gray PNG holding ``rows`` (or ``data``) as its image data."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    body = rows.tobytes() if data is None else data
    header = struct.pack(">IIBBBBB", width, rows.shape[0], depth, 0, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                 + chunk(b"IDAT", zlib.compress(body, 6)) + chunk(b"IEND", b""))


def host_pixels(rows: np.ndarray, depth: int) -> np.ndarray:
    """The plain host unfilter and the reader's byte swap."""
    h, pitch = rows.shape
    raw = png_reader._unfilter(memoryview(rows.tobytes()), h, pitch - 1, depth // 8)
    return raw.view(">u2").astype(np.uint16) if depth == 16 else raw


@pytest.mark.parametrize("color,depth", CASES)
@pytest.mark.parametrize("interlace", [0, 1])
def test_rows_are_handed_over_by_header(tmp_path, color, depth, interlace):
    path = str(tmp_path / "case.png")
    make_case(path, color, depth, interlace, 0)
    got = png_reader.read_png_rows(path)
    if color == 0 and depth in (8, 16) and not interlace:
        assert isinstance(got, png_reader.FilteredRows) and got.depth == depth
        assert got.shape == (13, 11) and got.rows.shape == (13, 1 + 11 * depth // 8)
        assert not got.rows.flags.writeable  # zlib's output, not a copy
        np.testing.assert_array_equal(plain_png_unfilter(torch.from_numpy(got.rows.copy()[None]),
                                                         depth)[0].numpy(), png_reader.decode_png(path))
    else:
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, png_reader.decode_png(path))


@pytest.mark.parametrize("fault", ["filter byte", "short data"])
def test_a_bad_file_on_the_hand_off_path_is_skipped_and_logged(tmp_path, fault):
    rng = np.random.default_rng(1)
    rows = chip_smoke.filter_rows(rng.integers(0, 256, size=(6, 10), dtype=np.uint8), 2,
                                  [4, 1, 2, 3, 0, 4])
    path = str(tmp_path / "bad.png")
    if fault == "filter byte":
        rows[3, 0] = 7
        write_gray(path, rows, 5, 16)
        message = "unknown PNG row filter 7"
    else:
        write_gray(path, rows, 5, 16, data=rows.tobytes()[:-3])
        message = "PNG image data is shorter than its header says"
    for read in (png_reader.read_png_rows, png_reader.decode_png):
        with pytest.raises(ValueError, match=message):
            read(path)
    encoder = _Encoder.__new__(_Encoder)  # the decode alone needs no tower
    encoder._failed_lock, encoder._decode_seconds = threading.Lock(), []
    failed = str(tmp_path / "failed.txt")
    assert encoder._safe_decode(path, failed, card_rows=True) is None
    assert open(failed).read() == f"{path}\n{message}\n\n"


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_plain_unfilter_equals_the_host(kind, depth):
    rng = np.random.default_rng(depth + (9 if kind == "mixed" else kind))
    bpp = depth // 8
    for h, w in [(9, 7), (7, 29), (5, 1)]:  # odd widths, one-pixel rows
        images = []
        for _ in range(3):
            raw = rng.integers(0, 256, size=(h, w * bpp), dtype=np.uint8)
            raw[2] = 255  # saturated: Average's left + up passes a byte
            raw[3] = 0
            images.append(chip_smoke.filter_rows(
                raw, bpp, rng.integers(0, 5, h) if kind == "mixed" else np.full(h, kind)))
        rows = np.stack(images)
        out = png_unfilter(torch.from_numpy(rows), depth)
        assert out.dtype == (torch.uint16 if depth == 16 else torch.uint8)
        for i, image in enumerate(rows):
            np.testing.assert_array_equal(out[i].numpy(), host_pixels(image, depth))


def test_plain_unfilter_gives_zeros_for_pad_images_and_refuses_bad_bytes():
    rows = torch.zeros(2, 4, 1 + 2 * 3, dtype=torch.uint8)
    assert not plain_png_unfilter(rows, 16).any()
    rows[1, 2, 0] = 5
    with pytest.raises(ValueError, match="unknown PNG row filter 5"):
        plain_png_unfilter(rows, 16)
    with pytest.raises(ValueError, match="no whole pixels"):
        plain_png_unfilter(torch.zeros(1, 2, 4, dtype=torch.uint8), 16)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Five 16-bit and three 8-bit gray PNGs (Paeth and mixed rows, two
    shapes) and one palette PNG, and the micro tower's config."""
    root = tmp_path_factory.mktemp("rows")
    rng = np.random.default_rng(5)
    items = []
    for i, (h, w, depth) in enumerate([(40, 36, 16)] * 3 + [(45, 38, 16)] * 2 + [(40, 36, 8)] * 3):
        pixels = chip_smoke.synthetic_mammogram(h, w, seed=i)
        raw = (pixels.astype(">u2").view(np.uint8) if depth == 16
               else (pixels >> 8).astype(np.uint8))
        kinds = np.full(h, 4) if i % 2 else rng.integers(0, 5, h)
        path = str(root / f"view_{i}.png")
        write_gray(path, chip_smoke.filter_rows(raw.reshape(h, -1), depth // 8, kinds), w, depth)
        items.append((path, path))
    palette, bad = str(root / "palette.png"), str(root / "bad.png")
    make_case(palette, 3, 8, 0, 0)
    rows = chip_smoke.filter_rows(np.zeros((4, 6), np.uint8), 2, [4, 4, 9, 4])
    write_gray(bad, rows, 3, 16)  # an unknown filter byte: skipped and logged
    items += [(palette, palette), (bad, bad)]
    cfg = compose(os.path.join(REPO, "configs"), "train_binary_class_clf",
                  [f"base.features_export_dir={root / 'store'}"])
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1})
    return cfg, items, str(root / "failed.txt")


def _encode(encoder, items, failed, traced=False):
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's sums follow the thread count
    profiling.reset_spans()
    try:
        if traced:
            with torch.profiler.profile(activities=CPU):
                encoder.encode_batches(items, out.__setitem__, failed)
        else:
            encoder.encode_batches(items, out.__setitem__, failed)
        return out, profiling.spans()
    finally:
        torch.set_num_threads(threads)
        profiling.reset_spans()


def test_the_card_route_follows_the_path(store):
    cfg = store[0]
    assert not _Encoder(cfg, device="cpu")._unfilters_on_card()
    encoder = _Encoder(cfg, device="cpu")
    encoder.devices = [torch.device("cuda", 0)]  # the route only reads the devices' kinds
    assert encoder._unfilters_on_card()
    for knob, value in (("prepool", 2), ("bucket_rounding", 64)):
        setattr(encoder, knob, value)
        assert not encoder._unfilters_on_card(), knob
        setattr(encoder, knob, 0)


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
def test_the_card_route_gives_the_host_routes_features(store, monkeypatch, tmp_path, devices):
    cfg, items, _failed = store
    failed = str(tmp_path / "failed.txt")
    host = _Encoder(cfg, batch_size=2, device=devices)
    want, spans = _encode(host, items, failed, traced=True)
    decodes = [r for r in spans if r["name"] == "encode.decode"]
    assert len(decodes) == len(items)
    assert [r["attrs"]["unfilter"] for r in sorted(decodes, key=lambda r: r["attrs"]["item"])] \
        == ["host"] * (len(items) - 1) + [None]

    monkeypatch.setattr(_Encoder, "_unfilters_on_card", lambda self: True)
    card = _Encoder(cfg, batch_size=2, device=devices)
    got, spans = _encode(card, items, failed, traced=True)
    assert sorted(got) == sorted(want) == sorted(p for p, _k in items[:-1])
    for key, vec in want.items():
        assert np.array_equal(got[key], vec), key
    where = [r["attrs"]["unfilter"]
             for r in sorted(spans, key=lambda r: r["attrs"].get("item", -1))
             if r["name"] == "encode.decode"]
    assert where == ["card"] * (len(items) - 2) + ["host", None]
    assert open(failed).read().count(items[-1][0] + "\nunknown PNG row filter 9\n") == 2
    # 16-bit 40x36: 2 batches; 45x38: 1; 8-bit: 2; the palette file: 1
    (root,) = [r for r in spans if r["name"] == "encode.pass"]
    assert root["attrs"]["batches"] == 6

"""The generators: the same seed gives the same inputs, every seed the same work."""

import numpy as np
import pytest

from portbench.data import phantom, png16, vocab, weights
from portbench.generators import train
from portbench.reference.text import WordPiece

SEEDS = (2 ** 31 + 11, 2 ** 33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_phantom_is_deterministic_and_shaped(seed):
    a = phantom.phantom(seed, 3, 120, 100)
    assert np.array_equal(a, phantom.phantom(seed, 3, 120, 100))
    assert not np.array_equal(a, phantom.phantom(seed + 1, 3, 120, 100))
    assert a.dtype == np.uint16 and a.max() <= 4095
    assert 0.35 < (a == 0).mean() < 0.55  # the background


def test_png_writer_round_trips_through_the_port(tmp_path):
    from mmgclip_tpu_torch.ingest.png_reader import decode_png

    pixels = phantom.phantom(SEEDS[0], 0, 70, 53)
    path = str(tmp_path / "x.png")
    png16.write_png16(path, pixels)
    assert np.array_equal(decode_png(path), pixels)


def test_paeth_filter_matches_the_standard():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(5, 12), dtype=np.uint8)
    out = png16.paeth_filter(raw, 2)
    for r in range(5):
        for c in range(12):
            a = int(raw[r, c - 2]) if c >= 2 else 0
            b = int(raw[r - 1, c]) if r else 0
            d = int(raw[r - 1, c - 2]) if r and c >= 2 else 0
            p = a + b - d
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - d)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else d)
            assert out[r, c] == (int(raw[r, c]) - pred) % 256


@pytest.mark.parametrize("seed", SEEDS)
def test_train_bank_is_deterministic_with_equal_text_counts(seed, tmp_path):
    texts = ["Finding suggesting benign.", "BIRADS score of 2."]
    tok = WordPiece(vocab.write_vocab(str(tmp_path / "v.txt"), texts, 600))
    f1, idx1, enc1 = train.bank(seed, 64, 16, texts, tok, 32)
    f2, idx2, enc2 = train.bank(seed, 64, 16, texts, tok, 32)
    assert np.array_equal(f1, f2) and np.array_equal(idx1, idx2)
    assert np.bincount(idx1).tolist() == [32, 32]
    assert not np.array_equal(f1, train.bank(seed + 1, 64, 16, texts, tok, 32)[0])


def test_weights_are_one_seeded_draw():
    maker = weights.convnext_tree((1, 1, 2, 1), (8, 16, 32, 64), 1, 2, 0.1)
    a, file_a = maker.make(weights.tree_seed(SEEDS[0], "convnext"), "cpu", bf16=True)
    b, _ = maker.make(weights.tree_seed(SEEDS[0], "convnext"), "cpu", bf16=True)
    c, _ = maker.make(weights.tree_seed(SEEDS[1], "convnext"), "cpu", bf16=True)
    assert np.array_equal(a["stage_2"]["pwconv1_kernel"], b["stage_2"]["pwconv1_kernel"])
    assert not np.array_equal(a["stage_2"]["pwconv1_kernel"], c["stage_2"]["pwconv1_kernel"])
    widened = (file_a["stage_0"]["gamma"].bits.astype(np.uint32) << 16).view(np.float32)
    assert np.array_equal(widened, a["stage_0"]["gamma"])
    assert abs(float(a["stage_1"]["gamma"].mean()) - 0.1) < 0.02


def test_vocabulary_has_the_published_size(tmp_path):
    path = vocab.write_vocab(str(tmp_path / "v.txt"), ["BIRADS score of 3."], 28996)
    lines = open(path, encoding="utf-8").read().splitlines()
    assert len(lines) == 28996 and lines[:5] == vocab.SPECIALS and "birads" in lines

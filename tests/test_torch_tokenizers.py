"""The port's tokenizer backends against the JAX package's and ``sacremoses``.

* Native WordPiece: the port builds its own copy of the C++ encoder
  (``csrc/wordpiece.cc``, by the host C++ compiler into ``_build/``); its ids
  equal ``mmgclip_tpu.data.native_wordpiece``'s and the Python WordPiece's
  on the prompt banks, the fixture reports and adversarial ASCII, and
  non-ASCII batches take the Python path.
* The Moses word split (``data/moses.py``, no ``sacremoses``) equals
  ``sacremoses.MosesTokenizer(lang="en").tokenize(..., aggressive_dash_splits
  =True, escape=True)`` on the in-repo corpus, the fixture reports and
  hypothesis strings; its range tables equal sacremoses' data.
* Moses+BPE: ``learn_bpe_from_corpus`` gives JAX's vocab and merges;
  ``Tokenizer.from_pretrained`` gives JAX's ids for ``microsoft/biogpt`` and
  for a local ``vocab.json`` + ``merges.txt`` directory.
"""

import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import sacremoses
from fixtures import build_study_report_fixture
from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from mmgclip_tpu.data.tokenizer import _default_corpus
from mmgclip_tpu.data.tokenizer import learn_bpe_from_corpus as jax_learn_bpe
from mmgclip_tpu_torch.data import moses_tables
from mmgclip_tpu_torch.data.moses import in_ranges, moses_tokenize
from mmgclip_tpu_torch.data.native_wordpiece import NativeWordPiece
from mmgclip_tpu_torch.data.tokenizer import Tokenizer, WordPieceTokenizer, learn_bpe_from_corpus
from mmgclip_tpu_torch.ops import _build
from torch_shims import load_jax_shim

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "vocab_fixture.txt")
MOSES = sacremoses.MosesTokenizer(lang="en")


def sacremoses_split(text):
    return MOSES.tokenize(text, aggressive_dash_splits=True, return_str=False, escape=True)


@pytest.fixture(scope="module")
def fixture_reports(tmp_path_factory):
    """The report and impression texts of the study fixture and of the smoke's
    seeded exam rows."""
    import chip_smoke
    from mmgclip_tpu_torch.data.csv_table import read_csv

    reports_csv = build_study_report_fixture(str(tmp_path_factory.mktemp("reports")), 12)[0]
    rows = read_csv(reports_csv, index_col=0).rows
    rng = np.random.default_rng(0)
    rows += [chip_smoke.exam_row(i, "", rng) for i in range(12)]
    return [r[k] for r in rows for k in ("image_description", "image_impression")]


def bank_sentences():
    return [text.replace("{M_MARG}", "spiculated").replace("{B_SCORE}", "4").replace("{E}", "mass")
            for text in _default_corpus()]


ADVERSARIAL = ["", "   ", "a", "A.B.C", "x" * 150, "[CLS] [SEP] [PAD]", "tab\there\nnew\rline",
               "ctrl\x01\x7fchars", "Mass, 5 mm; BI-RADS 4/5 (suspicious)!", "don't l'ecole --",
               "x " * 300]


# ----------------------------------------------------------------------
# native WordPiece

def test_native_wordpiece_builds_from_the_ports_own_source():
    from mmgclip_tpu_torch.data import native_wordpiece

    lib = native_wordpiece.load_library()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert "wordpiece" in os.path.basename(lib._name) and "native" not in lib._name


@pytest.mark.parametrize("vocab", ["corpus", "fixture"])
@pytest.mark.parametrize("max_len", [2, 8, 64])
def test_native_wordpiece_equals_python_and_jax(vocab, max_len, fixture_reports):
    from mmgclip_tpu.data import native_wordpiece as jax_native

    ours = WordPieceTokenizer() if vocab == "corpus" else WordPieceTokenizer.from_vocab_file(VOCAB)
    texts = [t for t in bank_sentences() + fixture_reports + ADVERSARIAL if t.isascii()]
    native = NativeWordPiece(ours.vocab).encode_batch(texts, max_len)
    assert native is not None
    python = Tokenizer(ours, max_len)
    python._native_tried = True  # the pure-Python path
    want = python(texts, max_length=max_len)
    assert np.array_equal(native[0], want["input_ids"]) and np.array_equal(native[1], want["attention_mask"])
    if load_jax_shim(jax_native, "libmmg_wordpiece.so") is not None:
        theirs = jax_native.NativeWordPiece(ours.vocab).encode_batch(texts, max_len)
        assert np.array_equal(native[0], theirs[0]) and np.array_equal(native[1], theirs[1])


@pytest.mark.parametrize("native", ["1", "0"])
def test_tokenizer_routes_ascii_batches_as_jax_does(native, monkeypatch, fixture_reports):
    monkeypatch.setenv("MMGCLIP_NATIVE_TOKENIZER", native)
    name = "emilyalsentzer/Bio_ClinicalBERT"
    ours, theirs = Tokenizer.from_pretrained(name, 32), JaxTokenizer.from_pretrained(name, 32)
    assert (ours._native_backend() is not None) == (native == "1")
    for texts in (bank_sentences(), fixture_reports, ["Élan naïve", "ascii"]):
        for padding in ("max_length", "longest"):
            a, b = ours(texts, padding=padding), theirs(texts, padding=padding)
            for key in b:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_native_wordpiece_refuses_vocabularies_it_cannot_hold():
    with pytest.raises(ValueError, match="dense"):
        NativeWordPiece({"[PAD]": 0, "a": 2})
    with pytest.raises(ValueError, match="newline"):
        NativeWordPiece({"[PAD]": 0, "a\nb": 1})
    assert NativeWordPiece({"[PAD]": 0, "a": 1}).encode_batch(["é"], 8) is None


# ----------------------------------------------------------------------
# Moses

def _ranges(chars):
    out = []
    for code in sorted(set(map(ord, chars))):
        if out and out[-1] + 1 == code:
            out[-1] = code
        else:
            out += [code, code]
    return tuple(out)


@pytest.mark.parametrize("name", ["IsN", "IsAlnum", "IsAlpha", "IsLower"])
def test_moses_range_tables_equal_sacremoses_data(name):
    table = getattr(moses_tables, name.upper())
    assert table == _ranges(getattr(sacremoses.MosesTokenizer, name))
    for code in range(0, 0x3000, 7):
        assert in_ranges(table, chr(code)) == (chr(code) in getattr(sacremoses.MosesTokenizer, name))


def test_moses_nonbreaking_prefixes_equal_sacremoses():
    assert list(moses_tables.NONBREAKING_PREFIXES_EN) == MOSES.NONBREAKING_PREFIXES


def test_moses_split_equals_sacremoses_on_the_corpus_and_reports(fixture_reports):
    for text in _default_corpus() + fixture_reports + ADVERSARIAL:
        assert moses_tokenize(text) == sacremoses_split(text), text


PIECES = st.sampled_from(["-", "--", "—", "–", "'", "'s", "n't", "&", "<", ">", '"', "|", "[", "]",
                          "1,000", "3.5", ",", ".", "...", "..", "5,", ",5", "é", "naïve", "Café",
                          "Mr.", "No.", "no.", "pp.", "e.g.", "U.S.", "Art.", "a", "B", "x1-y2",
                          "BI-RADS", "1990's", "'tis", "  ", "\t", "?", "!", "%", "@", "#", "$5",
                          "(", ")", "/", "ñ", "9", "ABC.", "abc"])


@settings(max_examples=200, deadline=None)
@given(st.lists(PIECES, max_size=12).map("".join), st.lists(PIECES, max_size=8).map(" ".join))
def test_moses_split_equals_sacremoses_on_hypothesis_strings(joined, spaced):
    for text in (joined, spaced, spaced + "."):
        assert moses_tokenize(text) == sacremoses_split(text), repr(text)


# ----------------------------------------------------------------------
# Moses+BPE

def test_learned_bpe_equals_jax():
    corpus = _default_corpus()
    for merges in (64, 512):
        vocab, learned = learn_bpe_from_corpus(corpus, merges)
        jax_vocab, jax_learned = jax_learn_bpe(corpus, merges)
        assert vocab == jax_vocab and [tuple(m) for m in learned] == [tuple(m) for m in jax_learned]


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    vocab, merges = jax_learn_bpe(_default_corpus(), num_merges=256)
    d = tmp_path_factory.mktemp("bpe_files")
    with open(d / "vocab.json", "w", encoding="utf-8") as fh:
        json.dump(vocab, fh, ensure_ascii=False)
    with open(d / "merges.txt", "w", encoding="utf-8") as fh:
        fh.writelines(" ".join(m) + "\n" for m in merges)
    return str(d)


@pytest.mark.parametrize("source", ["microsoft/biogpt", "local files"])
@pytest.mark.parametrize("padding,max_length", [("max_length", 64), ("longest", 16)])
def test_bpe_ids_equal_jax(source, padding, max_length, bpe_dir, fixture_reports):
    name = bpe_dir if source == "local files" else source
    ours, theirs = Tokenizer.from_pretrained(name, 64), JaxTokenizer.from_pretrained(name, 64)
    assert ours.vocab_size == theirs.vocab_size and ours._native_backend() is None
    texts = bank_sentences() + fixture_reports + ADVERSARIAL + ["Élan — naïve, l'ecole."]
    a = ours(texts, padding=padding, max_length=max_length)
    b = theirs(texts, padding=padding, max_length=max_length)
    assert set(a) == set(b)
    for key in b:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    assert (a["input_ids"][:, 0] == ours._backend.sep_id).all()  # the fairseq </s> X framing


def test_vocab_file_and_directory_dispatch_as_jax(tmp_path, bpe_dir):
    both = tmp_path / "both"
    both.mkdir()
    for name in ("vocab.json", "merges.txt"):
        (both / name).write_bytes(open(os.path.join(bpe_dir, name), "rb").read())
    (both / "vocab.txt").write_bytes(open(VOCAB, "rb").read())
    wp_dir = tmp_path / "wp"
    wp_dir.mkdir()
    (wp_dir / "vocab.txt").write_bytes(open(VOCAB, "rb").read())
    for name in (str(both), str(wp_dir)):
        assert type(Tokenizer.from_pretrained(name)._backend).__name__ == \
            type(JaxTokenizer.from_pretrained(name)._backend).__name__
    assert isinstance(Tokenizer.from_pretrained(VOCAB)._backend, WordPieceTokenizer)
    assert isinstance(JaxTokenizer.from_pretrained(str(wp_dir))._backend, JaxWordPiece)

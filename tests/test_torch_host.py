"""The port's host-side modules against the JAX package's: bit-equal.

Covers the YAML reader (against PyYAML and the JAX package's loader on every
file under ``configs/`` and on the prompt banks), config composition, token
ids, prompt sampling and report text, the flax-msgpack and checkpoint
readers, PNG decoding, intensity preprocessing and view fusion.
"""

import glob
import os
import pickle
import random
import struct
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from fixtures import write_png
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.config import recompose as jax_recompose
from mmgclip_tpu.config.compose import _yaml_load
from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.evaluation.report_cascade import BANKS as JAX_BANKS
from mmgclip_tpu.evaluation.report_text import generate_report as jax_generate_report
from mmgclip_tpu.ingest.png_reader import decode_png as jax_decode_png
from mmgclip_tpu.ops.fusion import fuse_views as jax_fuse_views
from mmgclip_tpu.ops.preprocess import intensity_transform as jax_intensity
from mmgclip_tpu.prompts import generator as jax_generator
from mmgclip_tpu_torch.config import compose, recompose, yaml_lite
from mmgclip_tpu_torch.data.tokenizer import Tokenizer
from mmgclip_tpu_torch.evaluation.report_cascade import BANKS, BANK_ORDER
from mmgclip_tpu_torch.evaluation.report_text import generate_report
from mmgclip_tpu_torch.ingest.png_reader import decode_png
from mmgclip_tpu_torch.ops.fusion import fuse_views
from mmgclip_tpu_torch.ops.preprocess import intensity_transform
from mmgclip_tpu_torch.prompts import generator
from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
from mmgclip_tpu_torch.utils.flax_msgpack import from_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
CONFIG_FILES = sorted(os.path.relpath(p, REPO)
                      for p in glob.glob(os.path.join(CONFIGS, "**", "*.yaml"), recursive=True))
DEMO_RUN = os.path.join(REPO, "outputs", "demo", "run")
CHECKPOINT = os.path.join(DEMO_RUN, "checkpoints", "model.msgpack")


def assert_tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for key in b:
            assert_tree_equal(a[key], b[key], f"{path}/{key}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


# --- YAML -----------------------------------------------------------------
@pytest.mark.parametrize("path", CONFIG_FILES + [os.path.relpath(os.path.join(DEMO_RUN, ".hydra", "config.yaml"), REPO)])
def test_yaml_lite_matches_the_jax_loader(path):
    with open(os.path.join(REPO, path)) as fh:
        ref = _yaml_load(fh)
    assert yaml_lite.load_file(os.path.join(REPO, path)) == ref


def test_yaml_lite_reads_the_prompt_banks_like_pyyaml():
    path = os.path.join(REPO, "mmgclip_tpu_torch", "prompts", "banks.yaml")
    with open(path) as fh:
        assert yaml_lite.load_file(path) == yaml.safe_load(fh)
    with open(os.path.join(REPO, "mmgclip_tpu", "prompts", "banks.yaml")) as a, open(path) as b:
        assert a.read() == b.read()  # the port's copy is the JAX package's file


@pytest.mark.parametrize("text", [
    "a: [1, 2.5, 'x', \"y\\n\", [], {}, {k: v}]\nb: 5e-5\nc: .5\nd: -1e+3\n",
    "seq:\n- x: 1\n  y: [a, b]\n- plain text\n  continued\n- - nested\n  - list\n",
    "k: yes\nl: Off\nm: ~\nn: 0x1F\no: 017\np: 'it''s'\nq: .inf\nr: -.inf\ns: 1_000\n",
    "'quoted: key': value # comment\n\"k2\": \"a # not a comment\"\nurl: http://x:80/y\n",
    "top:\n  deep:\n    deeper: 1\n  list:\n  - 1\n  - 2\nafter: ''\n",
])
def test_yaml_lite_matches_the_jax_loader_on_dialect_samples(text):
    assert yaml_lite.load(text) == _yaml_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: |\n  block\n", "a: 1\n---\nb: 2\n", "a: 'open\n"])
def test_yaml_lite_rejects_what_it_does_not_read(text):
    with pytest.raises(yaml_lite.YamlError):
        yaml_lite.load(text)


# --- config composition ------------------------------------------------------
COMPOSE_CASES = [
    ("train_binary_class_clf", []),
    ("train_binary_class_clf", ["networks=clip_convnext_fused_bert"]),
    ("train_binary_class_clf", ["networks=clip_convnext_fused_bert",
                                "networks.image_encoder.config.use_fused_blocks=false"]),
    ("train_binary_class_clf", ["dataset=multi-label", "projection=2xLinear512",
                                "optimizer.config.learning_rate=5e-5", "base.seed=7"]),
    ("train_binary_class_clf", ["tokenizer.config.sequence_length=32", "dataset.config.encode_window=[32767.5, 65535]"]),
    ("train_multi_class_clf", []),
    ("train_prompt_clf", []),
    ("train_exam_reports_clf", []),
    ("evaluate_cnn_clf", []),
]


@pytest.mark.parametrize("name,overrides", COMPOSE_CASES)
def test_compose_matches_jax(monkeypatch, tmp_path, name, overrides):
    stamp = time.localtime()
    monkeypatch.setattr(time, "localtime", lambda *a: stamp)
    ref = jax_compose(CONFIGS, name, list(overrides)).to_dict()
    assert compose(CONFIGS, name, list(overrides)).to_dict() == ref
    run_dir = str(tmp_path)
    assert (compose(CONFIGS, name, list(overrides), run_dir=run_dir).to_dict()
            == jax_compose(CONFIGS, name, list(overrides), run_dir=run_dir).to_dict())


def test_recompose_matches_jax():
    assert recompose(DEMO_RUN).to_dict() == jax_recompose(DEMO_RUN).to_dict()


# --- tokenizer, prompts and report text --------------------------------------
def all_bank_sentences():
    banks = generator._banks()
    out = []

    def collect(node):
        if isinstance(node, str):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, list):
            for v in node:
                collect(v)

    collect(banks)
    return out + [p for name in BANK_ORDER for p in BANKS[name]]


@pytest.mark.parametrize("max_length,padding", [(256, "max_length"), (32, "max_length"),
                                                (8, "max_length"), (None, "longest")])
def test_token_ids_are_bit_equal(monkeypatch, max_length, padding):
    monkeypatch.setenv("MMGCLIP_NATIVE_TOKENIZER", "0")  # the JAX pure-Python path
    name = "emilyalsentzer/Bio_ClinicalBERT"
    ours, theirs = Tokenizer.from_pretrained(name, 256), JaxTokenizer.from_pretrained(name, 256)
    assert ours.vocab_size == theirs.vocab_size
    texts = all_bank_sentences() + ["Élan, ünïcode — test!", "x " * 300]
    a = ours(texts, padding=padding, max_length=max_length)
    b = theirs(texts, padding=padding, max_length=max_length)
    assert set(a) == set(b)
    for key in b:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_tokenizer_refuses_families_it_cannot_tokenize():
    with pytest.raises(NotImplementedError):
        Tokenizer.from_pretrained("microsoft/biogpt")
    with pytest.raises(NotImplementedError):
        Tokenizer.from_pretrained("mistralai/Mistral-7B-v0.1")


def test_report_banks_equal_jax():
    assert BANKS == JAX_BANKS


def random_decisions(rng):
    return {name: rng.randrange(len(BANKS[name])) for name in BANK_ORDER}


@pytest.mark.parametrize("bug_compat", [True, False])
def test_report_text_is_byte_equal(bug_compat):
    rng = random.Random(0)
    for i in range(60):
        decisions = random_decisions(rng)
        decisions["mass_type"] = i % 3  # every branch
        ours = generate_report(decisions, rng=random.Random(i), bug_compat=bug_compat)
        theirs = jax_generate_report(decisions, rng=random.Random(i), bug_compat=bug_compat)
        assert ours == theirs


@pytest.mark.parametrize("key,slots", [
    ("gtr_mass:True", {"M_MALIG": "benign", "M_MARG": "unknown", "M_SHAPE": "oval"}),
    ("gtr_mass:True", {"M_MALIG": "malignant", "M_MARG": "unknown", "M_SHAPE": "unknown"}),
    ("gtr_calc:True", {"C_MALIG": "benign", "C_DIST": "grouped"}),
    ("row.labels['birads']:True", {"B_SCORE": "4"}),
    ("gtr_is_architectural_distortion:False", {}),
])
def test_prompt_sentences_are_equal(key, slots):
    for seed in range(5):
        assert (generator.generate_gtr_prompt_sentence(key, n=1, rng=random.Random(seed), **slots)
                == jax_generator.generate_gtr_prompt_sentence(key, n=1, rng=random.Random(seed), **slots))
    for seed in range(5):
        assert (generator.generate_label_prompt_sentence("mass", "positive", n=1, template="HAS_MASS",
                                                         rng=random.Random(seed))
                == jax_generator.generate_label_prompt_sentence("mass", "positive", n=1, template="HAS_MASS",
                                                                rng=random.Random(seed)))


# --- flax msgpack, checkpoints -------------------------------------------------
def test_flax_msgpack_reader_matches_flax_on_the_demo_checkpoint():
    with open(CHECKPOINT, "rb") as fh:
        state = pickle.load(fh)
    assert_tree_equal(from_bytes(state["params"]), serialization.msgpack_restore(state["params"]))


def test_flax_msgpack_reader_round_trips_leaf_kinds():
    tree = {"a": {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "y": np.float32(2.5),
                  "z": np.arange(5, dtype=np.int32), "b": np.array([True, False])},
            "e": np.zeros((0, 4), np.float32), "s": "text", "n": None, "i": -70000, "f": 0.25}
    out = from_bytes(serialization.to_bytes(tree))
    assert_tree_equal({k: v for k, v in out.items() if k not in ("s", "n", "i", "f")},
                      {k: v for k, v in tree.items() if k not in ("s", "n", "i", "f")})
    assert (out["s"], out["n"], out["i"], out["f"]) == ("text", None, -70000, 0.25)
    bf16 = from_bytes(serialization.to_bytes({"w": jnp.asarray([1.5, -2.0, 3.0], jnp.bfloat16)}))
    np.testing.assert_array_equal(bf16["w"], np.array([1.5, -2.0, 3.0], np.float32))


def test_load_checkpoint_matches_flax():
    with open(CHECKPOINT, "rb") as fh:
        state = pickle.load(fh)
    out = load_checkpoint(CHECKPOINT)
    assert out["epoch"] == state["epoch"] and out["val_loss"] == state["val_loss"]
    assert_tree_equal(out["params"], serialization.msgpack_restore(state["params"]))


# --- PNG decode ------------------------------------------------------------------
def png_bytes(pixels, depth, filters):
    """A grayscale PNG with the given per-row filter types (encoder for tests)."""
    h, w = pixels.shape
    bpp = depth // 8
    raw = pixels.astype(">u2").view(np.uint8).reshape(h, -1) if depth == 16 else pixels.astype(np.uint8)
    raw = raw.astype(np.int64)
    rows = []
    prev = np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
def test_png_decode_matches_the_jax_reader(tmp_path, depth, filters):
    rng = np.random.default_rng(depth + len(filters))
    dtype = np.uint8 if depth == 8 else np.uint16
    pixels = rng.integers(0, np.iinfo(dtype).max + 1, size=(23, 17)).astype(dtype)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as fh:
        fh.write(png_bytes(pixels, depth, filters))
    out = decode_png(path)
    assert out.dtype == dtype and np.array_equal(out, pixels)
    ref = jax_decode_png(path)
    assert ref.dtype == out.dtype and np.array_equal(out, ref)


def test_png_decode_matches_on_fixture_and_pil_files(tmp_path):
    from PIL import Image

    eight = str(tmp_path / "eight.png")
    write_png(eight, size=64, seed=3)
    sixteen = str(tmp_path / "sixteen.png")
    arr = (np.add.outer(np.arange(40), np.arange(61)) * 300).astype(np.uint16)
    Image.fromarray(arr).save(sixteen)
    for path in (eight, sixteen):
        out, ref = decode_png(path), jax_decode_png(path)
        assert out.dtype == ref.dtype and np.array_equal(out, ref)


def test_png_decode_rejects_colour(tmp_path):
    """Colour files decode to the JAX reader's gray values (tests/test_torch_png.py
    covers every colour type); only a colour type the standard lacks raises."""
    from PIL import Image

    path = str(tmp_path / "rgb.png")
    rgb = np.random.default_rng(4).integers(0, 256, (4, 5, 3), dtype=np.uint8)
    Image.fromarray(rgb, mode="RGB").save(path)
    out, ref = decode_png(path), jax_decode_png(path)
    assert out.dtype == ref.dtype == np.uint8 and np.array_equal(out, ref)
    data = bytearray(open(path, "rb").read())
    data[25] = 5  # IHDR colour type 5 does not exist
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="colour type 5"):
        decode_png(path)


# --- preprocessing and fusion ------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("window", [None, (32767.5, 65535.0), (20000.0, 30000.0)])
def test_intensity_transform_matches_jax(dtype, window):
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, np.iinfo(dtype).max + 1, size=(2, 9, 7)).astype(dtype)
    ref = np.asarray(jax_intensity(jnp.asarray(pixels), window=window))
    out = intensity_transform(torch.from_numpy(pixels), window=window).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("method", ["maxpool", "avgpool", "stack", "concat"])
def test_fuse_views_matches_jax(method):
    feats = np.random.default_rng(1).standard_normal((2, 4, 6)).astype(np.float32)
    for x in (feats, feats[0]):
        ref = np.asarray(jax_fuse_views(jnp.asarray(x), method))
        np.testing.assert_allclose(fuse_views(torch.from_numpy(x), method).numpy(), ref, rtol=1e-6)

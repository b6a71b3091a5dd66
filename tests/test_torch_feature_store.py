"""The port's feature-store encode path against the JAX package's.

On the fixture tree of ``tests/fixtures.py``: ``create_dataset_df`` rows,
the ``ImageFeatureExtractor`` store (same relative ``.npy`` paths, features
within 1e-4 of the JAX extractor's on the same converted micro-tower weights,
the same ``failed.txt`` entry for a corrupt PNG), the resize, prepool and
bucket-rounding programs against the JAX ``_Encoder``'s, the knob warnings
(``tests/test_resize.py``'s), the ``python -m mmgclip_tpu_torch.encode_images``
entry point, and the serving engine's prepooled encode against the store.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from fixtures import build_image_label_tree
from mmgclip_tpu.config import Config as JaxConfig
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.data import create_dataset_df as jax_create_dataset_df
from mmgclip_tpu.ingest.encode import ImageFeatureExtractor as JaxExtractor
from mmgclip_tpu.ingest.encode import _Encoder as JaxEncoder
from mmgclip_tpu.models.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from mmgclip_tpu.models.convnext import init_convnext
from mmgclip_tpu_torch.config import Config, compose
from mmgclip_tpu_torch.data.ingest import create_dataset_df
from mmgclip_tpu_torch.data.paths import create_dataset_path
from mmgclip_tpu_torch.ingest import encode as enc
from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor, _Encoder, host_prepool
from mmgclip_tpu_torch.ops.resize import host_block_sum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FEATURE_RTOL = 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    base, annotated, lists, _ = build_image_label_tree(root, n_benign=3, n_malignant=3,
                                                       image_size=40, feature_store=False)
    cfg = dataclass_micro()
    _module, params = init_convnext(cfg, seed=5, image_size=32)
    weights = os.path.join(root, "convnext_micro.npz")
    with open(weights, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(params)))
    return root, base, annotated, lists, weights


def dataclass_micro():
    import dataclasses

    return dataclasses.replace(JaxConvNeXtConfig.micro(), in_channels=1, layer_scale_init=0.5)


def configs(tree, out_dir, **dataset_knobs):
    """The same composed config in both packages."""
    root, base, annotated, lists, weights = tree
    overrides = [f"hydra.run.dir={root}/run", f"base.features_export_dir={out_dir}",
                 f"dataset.config.base_dataset_path={base}",
                 f"dataset.config.annotated_dataset_path={annotated}",
                 f"dataset.config.lists_dataset_path={lists}",
                 f"networks.image_encoder.convnext_tiny_clf_path={weights}"]
    overrides += [f"dataset.config.{k}={v}" for k, v in dataset_knobs.items()]
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", overrides)
    cfg = compose(CONFIGS, "train_binary_class_clf", overrides)
    jcfg.networks.image_encoder.config = JaxConfig({"micro": True, "in_channels": 1})
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1})
    return jcfg, cfg


def test_dataset_rows_equal_the_jax_dataframe(tree):
    jcfg, cfg = configs(tree, "unused")
    rows = create_dataset_df(cfg)
    expected = jax_create_dataset_df(jcfg).to_dict("records")
    assert len(rows) == 6
    assert [list(r) for r in rows] == [list(r) for r in expected]
    assert rows == expected


def test_extractor_store_equals_the_jax_store(tree, tmp_path):
    jcfg, cfg = configs(tree, str(tmp_path / "jax"))
    _jcfg2, cfg = configs(tree, str(tmp_path / "port"))
    rows = create_dataset_df(cfg)
    corrupt = str(tmp_path / "corrupt" / "2D_100micron" / "0" / "02" / "x.png")
    os.makedirs(os.path.dirname(corrupt))
    with open(corrupt, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    rows = rows + [{**rows[0], "image_path": corrupt}]
    import pandas as pd

    assert JaxExtractor(config=jcfg, dataset=pd.DataFrame(rows), batch_size=4).extract() == 6
    assert ImageFeatureExtractor(config=cfg, dataset=rows, batch_size=4,
                                 device="cpu").extract() == 6
    jax_files = {os.path.relpath(r["image_path"], str(tmp_path / "jax"))
                 for r in create_dataset_path(str(tmp_path / "jax"))}
    port_files = {os.path.relpath(r["image_path"], str(tmp_path / "port"))
                  for r in create_dataset_path(str(tmp_path / "port"))}
    assert port_files == jax_files and len(port_files) == 6
    for rel in sorted(port_files):
        ours = np.load(str(tmp_path / "port" / rel))
        theirs = np.load(str(tmp_path / "jax" / rel))
        assert ours.shape == theirs.shape == (1, 768, 1, 1) and ours.dtype == np.float32
        assert np.abs(ours - theirs).max() <= FEATURE_RTOL * np.abs(theirs).max()
    # the failure entry: the path, the decoder's message, a blank line (the
    # two decoders word their messages differently)
    for side in ("jax", "port"):
        lines = open(str(tmp_path / side / "failed.txt")).read().split("\n")
        assert lines[0] == corrupt and lines[1] and lines[2:] == ["", ""]


@pytest.mark.parametrize("source", [np.uint8, np.uint16])
@pytest.mark.parametrize("knobs", [
    {"encode_resize": "[24,20]", "encode_resize_precision": "highest"},
    {"encode_resize": "[24,20]", "encode_resize_precision": "highest", "encode_host_prepool": 2},
    {"encode_resize": "[24,20]", "encode_resize_precision": "highest",
     "encode_window": "[30000,20000]"},
    {"encode_bucket_rounding": 32},
])
def test_encode_programs_match_the_jax_encoder(tree, tmp_path, knobs, source):
    jcfg, cfg = configs(tree, str(tmp_path), **knobs)
    jax_encoder = JaxEncoder(jcfg, batch_size=2)
    encoder = _Encoder(cfg, batch_size=2, device="cpu")
    rng = np.random.default_rng(3)
    px = rng.integers(0, np.iinfo(source).max + 1, size=(2, 45, 38), dtype=source)
    if "encode_bucket_rounding" in knobs:
        canvas = np.zeros((2, 64, 64), source)
        canvas[:, :45, :38] = px
        valid = np.asarray([[45, 38], [45, 38]], np.int32)
        ref = jax_encoder._masked_encode_fn()(jnp.asarray(canvas), jnp.asarray(valid))
        out = encoder._masked_encode_fn()(torch.from_numpy(canvas), torch.from_numpy(valid))
    elif "encode_host_prepool" in knobs:
        ref = jax_encoder._resized_encode_fn()(jnp.asarray(host_block_sum(px, 2)),
                                               native_hw=(45, 38))
        sums, scale = host_prepool(px, 2)
        out = encoder._resized_encode_fn()(torch.from_numpy(sums), native_hw=(45, 38),
                                           scale=scale)
    else:
        ref = jax_encoder._resized_encode_fn()(jnp.asarray(px))
        out = encoder._resized_encode_fn()(torch.from_numpy(px))
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == ref.shape == (2, 768)
    assert np.abs(out - ref).max() <= FEATURE_RTOL * np.abs(ref).max()


def test_host_prepool_carries_the_source_scale():
    px8 = np.full((1, 4, 4), 255, np.uint8)
    px16 = np.full((1, 4, 4), 65535, np.uint16)
    sums8, scale8 = host_prepool(px8, 2)
    sums16, scale16 = host_prepool(px16, 2)
    assert sums8.dtype == np.uint16 and scale8 == 257.0 and sums8.max() == 4 * 255
    assert sums16.dtype == np.int32 and scale16 == 1.0 and sums16.max() == 4 * 65535


@pytest.fixture
def warnings(monkeypatch):
    seen = []
    monkeypatch.setattr(enc.logger, "warning", lambda msg, *a: seen.append(str(msg)))
    return seen


def tower_config(**knobs):
    cfg = compose(CONFIGS, "train_binary_class_clf", [])
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1, **knobs})
    return cfg


def test_unfused_int8_warns(warnings):
    enc.load_convnext_tower(tower_config(quant="int8"))
    assert any("use_fused_blocks" in w and "slowdown" in w for w in warnings)
    warnings.clear()
    _module, cn = enc.load_convnext_tower(tower_config(quant="int8", use_fused_blocks=True))
    assert cn.quant == "int8" and cn.use_fused_blocks
    assert not any("slowdown" in w for w in warnings)


def test_glue_knobs_without_fused_blocks_warn(warnings):
    for knobs in ({"fuse_stem": True}, {"fuse_downsample": True}):
        warnings.clear()
        enc.load_convnext_tower(tower_config(**knobs))
        assert any("no effect without" in w for w in warnings)
    warnings.clear()
    _module, cn = enc.load_convnext_tower(tower_config(fuse_stem=True, fuse_downsample=True,
                                                       use_fused_blocks=True))
    assert cn.fuse_stem and cn.fuse_downsample
    assert not any("no effect" in w for w in warnings)


def test_fuse_downsample_on_masked_encodes_warns(warnings):
    cfg = tower_config(fuse_downsample=True, use_fused_blocks=True)
    cfg.dataset.config.encode_bucket_rounding = 32
    enc.load_convnext_tower(cfg)
    assert any("masked-tower encodes" in w for w in warnings)


def test_prepool_warns_when_blocks_coarser_than_output(tree, tmp_path, warnings):
    _jcfg, cfg = configs(tree, str(tmp_path / "enc"), encode_resize="[32,32]",
                         encode_host_prepool=4)
    png = create_dataset_df(cfg)[0]["image_path"]  # 40x40: downscale 1.25 < k = 4
    ex = ImageFeatureExtractor(config=cfg, dataset=[{"image_path": png}], batch_size=1,
                               device="cpu")
    assert ex.extract() == 1
    assert any("exceeds the downscale factor" in w for w in warnings)
    assert not any("TPU" in w for w in warnings)


def run_cli(args, tmp_path, env=None):
    return subprocess.run([sys.executable, "-m", "mmgclip_tpu_torch.encode_images", *args],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)


def cli_overrides(tree, out_dir):
    root, base, annotated, lists, weights = tree
    return [f"hydra.run.dir={out_dir}/run", f"base.features_export_dir={out_dir}/feats",
            f"dataset.config.base_dataset_path={base}",
            f"dataset.config.annotated_dataset_path={annotated}",
            f"dataset.config.lists_dataset_path={lists}",
            f"networks.image_encoder.convnext_tiny_clf_path={weights}",
            "networks.image_encoder.config.micro=true",
            "networks.image_encoder.config.in_channels=1"]


def test_encode_images_cli_on_the_cpu(tree, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    result = run_cli(["--device", "cpu", *cli_overrides(tree, str(tmp_path))], tmp_path, env)
    assert result.returncode == 0, result.stderr[-3000:]
    stored = create_dataset_path(str(tmp_path / "feats"))
    assert len(stored) == 6
    assert all(np.isfinite(np.load(r["image_path"])).all() for r in stored)


def test_encode_images_without_a_card_raises(tree, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    result = run_cli(cli_overrides(tree, str(tmp_path)), tmp_path, env)
    assert result.returncode != 0
    assert "CUDA is not available" in result.stderr
    assert not os.path.exists(str(tmp_path / "feats"))


def test_encoder_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _Encoder(tower_config())


def test_served_features_ride_the_stored_prepool_chain(tree, tmp_path):
    """InferenceEngine.encode_paths with encode_resize + encode_host_prepool
    gives the stored features of the same config."""
    from mmgclip_tpu_torch.config import recompose
    from mmgclip_tpu_torch.serving import InferenceEngine

    run = os.path.join(REPO, "outputs", "demo", "run")
    cfg = recompose(run)
    cfg.checkpoints.checkpoints_export_dir = os.path.join(run, "checkpoints")
    cfg.dataset.config.encode_resize = [24, 20]
    cfg.dataset.config.encode_host_prepool = 2
    cfg.base.features_export_dir = str(tmp_path / "feats")
    _jcfg, tree_cfg = configs(tree, "unused")
    pngs = [r["image_path"] for r in create_dataset_df(tree_cfg)[:3]]
    engine = InferenceEngine(cfg, device="cpu")
    try:
        served = engine.encode_paths(pngs)
    finally:
        engine.close()
    ex = ImageFeatureExtractor(config=cfg, dataset=[{"image_path": p} for p in pngs],
                               batch_size=2, device="cpu")
    assert ex.extract() == 3
    for png, vec in zip(pngs, served):
        stored = np.load(ex._export_path(png)).reshape(-1)
        np.testing.assert_allclose(vec, stored, rtol=1e-6, atol=1e-6)

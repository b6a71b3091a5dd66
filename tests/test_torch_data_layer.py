"""The port's host data layer of the encode path against the JAX package's:
paths and feature-store walking, the feature store IO, seeding, the CLI
parser, per-host sharding, and ``StudyFeatureExtractor`` (fused per-study
vectors within 1e-4 of the JAX extractor's on the same converted weights).
"""

import dataclasses
import os
import random

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

from fixtures import build_image_label_tree
from mmgclip_tpu.cli import parse_hydra_args as jax_parse_hydra_args
from mmgclip_tpu.config import Config as JaxConfig
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.data import paths as jax_paths
from mmgclip_tpu.data.store import load_features as jax_load_features
from mmgclip_tpu.ingest import StudyFeatureExtractor as JaxStudyExtractor
from mmgclip_tpu.ingest.encode import shard_items_for_host as jax_shard
from mmgclip_tpu.models.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from mmgclip_tpu.models.convnext import init_convnext
from mmgclip_tpu.utils.seeding import seeding as jax_seeding
from mmgclip_tpu_torch.cli import compose_run, parse_hydra_args
from mmgclip_tpu_torch.config import Config, compose
from mmgclip_tpu_torch.data import paths
from mmgclip_tpu_torch.data.store import load_features, load_features_batch, save_features
from mmgclip_tpu_torch.ingest.encode import StudyFeatureExtractor, shard_items_for_host
from mmgclip_tpu_torch.utils.seeding import create_directory_if_not_exists, seeding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    base, annotated, lists, features = build_image_label_tree(root, n_benign=4, n_malignant=2,
                                                              image_size=32)
    return root, base, features


def test_paths_match_jax(tree):
    _root, base, features = tree
    for image_id in ("p0200000102cl", "p1234567803mr"):
        assert paths.create_path(image_id, base) == jax_paths.create_path(image_id, base)
    assert paths.create_path("02000001", base) == jax_paths.create_path("02000001", base)
    assert paths.create_exam_path("0200000102", base) == jax_paths.create_exam_path("0200000102", base)
    items = ["normal_patients.txt", "malignant_patients.txt"]
    for text in ("normal", "malignant", "benign"):
        assert paths.find_similar_item(text, items) == jax_paths.find_similar_item(text, items)
    with pytest.raises(ValueError):
        paths.create_path("x", base)


def test_feature_store_walk_matches_jax(tree):
    _root, _base, features = tree
    rows = paths.create_dataset_path(features)
    assert len(rows) == 6
    assert rows == jax_paths.create_dataset_path(features).to_dict("records")


def test_store_roundtrip_and_reference_pth(tmp_path):
    vec = np.random.default_rng(0).standard_normal((1, 768, 1, 1)).astype(np.float32)
    path = save_features(str(tmp_path / "a" / "b"), vec)
    assert path.endswith("b.npy")
    np.testing.assert_array_equal(load_features(path), vec)
    pth = str(tmp_path / "ref.pth")
    torch.save(torch.tensor(vec), pth)
    np.testing.assert_array_equal(load_features(pth), jax_load_features(pth))
    assert load_features_batch([path, pth]).shape == (2, 1, 768, 1, 1)
    with pytest.raises(ValueError):
        load_features(str(tmp_path / "x.txt"))


def test_seeding_gives_the_jax_host_streams():
    ours, theirs = seeding(7), jax_seeding(7)
    assert ours.host.random() == theirs.host.random()
    np.testing.assert_array_equal(ours.numpy.integers(0, 100, 5), theirs.numpy.integers(0, 100, 5))
    seeding(3)
    a = (random.random(), np.random.rand(), torch.rand(1).item())
    seeding(3)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item())
    g1, g2 = ours.torch_generator(), ours.torch_generator()
    assert torch.equal(torch.randn(3, generator=g1), torch.randn(3, generator=g2))
    with pytest.raises(ValueError):
        create_directory_if_not_exists(None)


def test_cli_parses_like_jax(tmp_path):
    argv = ["--config-name", "train_exam_reports_clf", "base.seed=3", "dataset.config.x=[1,2]"]
    ours = parse_hydra_args("train_binary_class_clf", argv)
    theirs = jax_parse_hydra_args("train_binary_class_clf", argv)
    assert ours[1:] == theirs[1:] and os.path.samefile(ours[0], theirs[0])
    cfg = compose_run("train_binary_class_clf", [f"hydra.run.dir={tmp_path}/run", "base.seed=3"])
    assert cfg.base.seed == 3 and os.path.isdir(str(tmp_path / "run"))
    # the .hydra snapshot, read back by the JAX package's recompose as the same config
    from mmgclip_tpu.config import recompose as jax_recompose

    assert jax_recompose(str(tmp_path / "run")).to_dict() == cfg.to_dict()


@pytest.mark.parametrize("count", [1, 2, 3])
def test_shard_items_for_host_matches_jax(count):
    items = list(range(10))
    for index in range(count):
        assert shard_items_for_host(items, index, count) == jax_shard(items, index, count)
    assert shard_items_for_host(items) == items  # process 0 of 1 without torch.distributed


def test_study_extractor_matches_jax(tree, tmp_path):
    _root, base, _features = tree
    study_dirs = [os.path.join(base, shard, pid, "st02") for shard in sorted(os.listdir(base))
                  for pid in sorted(os.listdir(os.path.join(base, shard)))]
    study_dirs.append(str(tmp_path / "missing" / "st02"))  # logged to failed.txt, skipped
    cfg_micro = dataclasses.replace(JaxConvNeXtConfig.micro(), in_channels=1, layer_scale_init=0.5)
    _module, params = init_convnext(cfg_micro, seed=8, image_size=32)
    weights = str(tmp_path / "micro.npz")
    with open(weights, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(params)))
    out = {}
    for side, comp, conf, Extractor, rows in (
            ("jax", jax_compose, JaxConfig, JaxStudyExtractor,
             pd.DataFrame({"study_path": study_dirs})),
            ("port", compose, Config, StudyFeatureExtractor,
             [{"study_path": p} for p in study_dirs])):
        cfg = comp(CONFIGS, "train_exam_reports_clf", [
            f"base.features_export_dir={tmp_path / side}",
            f"networks.image_encoder.convnext_tiny_clf_path={weights}",
            "dataset.config.concatenate_features_method=avgpool",
            "dataset.config.n_images_per_study=4"], run_dir=str(tmp_path / "run"))
        cfg.networks.image_encoder.config = conf({"micro": True, "in_channels": 1})
        kwargs = {"device": "cpu"} if side == "port" else {}
        assert Extractor(config=cfg, dataset=rows, **kwargs).extract() == 6
        out[side] = {os.path.relpath(os.path.join(r, f), str(tmp_path / side)):
                     np.load(os.path.join(r, f))
                     for r, _d, fs in os.walk(str(tmp_path / side)) for f in fs if f.endswith(".npy")}
        failed = open(str(tmp_path / side / "failed.txt")).read().split("\n")
        assert failed[0] == study_dirs[-1]
    assert sorted(out["port"]) == sorted(out["jax"]) and len(out["port"]) == 6
    for key, theirs in out["jax"].items():
        ours = out["port"][key]
        assert ours.shape == theirs.shape == (768,)
        assert np.abs(ours - theirs).max() <= 1e-4 * np.abs(theirs).max()


def test_extractors_refuse_rows_without_their_column():
    cfg = compose(CONFIGS, "train_exam_reports_clf", [])
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1})
    with pytest.raises(ValueError, match="study_path"):
        StudyFeatureExtractor(config=cfg, dataset=[{"image_path": "x"}], device="cpu")
    with pytest.raises(ValueError, match="config"):
        StudyFeatureExtractor(config=None, dataset=[], device="cpu")

"""The feature-store encode's data axis against the JAX encoder's.

* **Replicas against JAX.**  The JAX ``ImageFeatureExtractor`` shards every
  batch over the 8 virtual CPU devices of ``tests/conftest.py``; the port's
  runs with ``device=["cpu"] * n`` for n in {1, 3, 8} (n tower replicas,
  each batch padded to a multiple of n rows and split in row blocks).  The
  plain program, resize + host prepool and bucket rounding 32, over five
  8-bit and five 16-bit PNGs (batches that do not split evenly): features
  within ``FEATURE_RTOL`` of JAX's (``tests/test_torch_feature_store.py``'s),
  and the batch size rounded as the JAX encoder rounds it for n devices.
* **Replicas against one device.**  The port with n replicas against the
  port with one, within ``SHARD_RTOL`` of the largest feature: a shard of
  one row makes the last downsample (1 x 1 pixels) a one-row product, for
  which the CPU's BLAS takes its matrix-vector path, which sums in another
  order (measured: 5e-7).  Every other op of the CPU tower gives each row
  the same bits whatever rows share its batch.
* **Ranks against one process.**  Two gloo ranks started with torchrun's
  environment run ``encode_images.main`` and ``encode_studies.main``
  (``--device cpu``) against one process: the stores' files, ``failed.txt``
  (the corrupt file once, the missing study once) and
  ``final_reports_dataset.csv`` byte-equal.
* **Errors.**  ``local_devices()`` and ``_Encoder(device=None)`` without a
  card raise.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

import chip_smoke
from fixtures import build_image_label_tree
from mmgclip_tpu.config import Config as JaxConfig
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.ingest import encode as jax_encode
from mmgclip_tpu.ingest.encode import ImageFeatureExtractor as JaxExtractor
from mmgclip_tpu.ingest.encode import _Encoder as JaxEncoder
from mmgclip_tpu.models.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from mmgclip_tpu.models.convnext import init_convnext
from mmgclip_tpu_torch import encode_images, encode_studies
from mmgclip_tpu_torch.config import Config, compose
from mmgclip_tpu_torch.data.paths import create_dataset_path
from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor, _Encoder
from mmgclip_tpu_torch.parallel.mesh import local_devices
from torch_dist import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FEATURE_RTOL = 1e-4  # tests/test_torch_feature_store.py
PROGRAMS = {
    "plain": {},
    "prepool": {"encode_resize": "[24,20]", "encode_resize_precision": "highest",
                "encode_host_prepool": 2},
    "rounding": {"encode_bucket_rounding": 32},
}
SHARD_RTOL = 1e-6
# (bits, shape, count): 5 images a bucket, so 3 and 8 replicas pad a batch
SOURCES = [(8, (40, 36), 5), (16, (45, 38), 5)]
BATCH = 4


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """8- and 16-bit PNGs under a ``2D_100micron`` root, and micro-tower
    weights converted from a JAX init."""
    root = tmp_path_factory.mktemp("devices")
    paths = []
    for bits, (h, w), count in SOURCES:
        for i in range(count):
            path = str(root / "2D_100micron" / "0" / f"{bits}" / f"img_{h}x{w}_{i}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            pixels = chip_smoke.synthetic_mammogram(h, w, seed=100 * bits + 10 * h + i)
            if bits == 8:
                chip_smoke.write_png8(path, (pixels >> 8).astype(np.uint8))
            else:
                chip_smoke.write_png16(path, pixels)
            paths.append(path)
    micro = dataclasses.replace(JaxConvNeXtConfig.micro(), in_channels=1, layer_scale_init=0.5)
    _module, params = init_convnext(micro, seed=6, image_size=32)
    weights = str(root / "micro.npz")
    with open(weights, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(params)))
    return str(root), paths, weights


def configs(weights, out_dir, knobs):
    overrides = [f"base.features_export_dir={out_dir}",
                 f"networks.image_encoder.convnext_tiny_clf_path={weights}"]
    overrides += [f"dataset.config.{k}={v}" for k, v in knobs.items()]
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", overrides)
    cfg = compose(CONFIGS, "train_binary_class_clf", overrides)
    jcfg.networks.image_encoder.config = JaxConfig({"micro": True, "in_channels": 1})
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1})
    return jcfg, cfg


def read_store(out_dir, paths):
    return np.stack([np.load(os.path.join(out_dir, p.split("2D_100micron/")[-1])
                             .replace(".png", ".npy")).reshape(-1) for p in paths])


_STORES = {}


def store(pngs, program, n):
    """The stored features of ``paths`` by the JAX extractor (n = "jax") or
    the port's with n CPU replicas, made once per module; and the batch
    size the extractor ran with."""
    key = (program, n)
    if key not in _STORES:
        root, paths, weights = pngs
        out = os.path.join(root, f"store_{program}_{n}")
        jcfg, cfg = configs(weights, out, PROGRAMS[program])
        rows = [{"image_path": p} for p in paths]
        if n == "jax":
            ex = JaxExtractor(config=jcfg, dataset=pd.DataFrame(rows), batch_size=BATCH)
        else:
            ex = ImageFeatureExtractor(config=cfg, dataset=rows, batch_size=BATCH,
                                       device=["cpu"] * n)
        assert ex.extract() == len(paths)
        _STORES[key] = read_store(out, paths), ex.batch_size
    return _STORES[key]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_replicas_match_the_jax_encoder(pngs, program, n):
    ref, jax_batch = store(pngs, program, "jax")
    assert jax_batch == 8 and len(jax.local_devices()) == 8
    ours, _batch = store(pngs, program, n)
    assert ours.shape == ref.shape == (len(pngs[1]), 768)
    assert np.abs(ours - ref).max() <= FEATURE_RTOL * np.abs(ref).max()


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("batch", [1, 4, 32])
def test_batch_rounding_matches_the_jax_encoder(pngs, n, batch, monkeypatch):
    """The JAX encoder over n devices (its tower stubbed: only the rounding
    runs) and the port over n replicas round the batch size alike."""
    jcfg, cfg = configs(pngs[2], os.path.join(pngs[0], "unused"), {})
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: jax.devices()[:n])
    monkeypatch.setattr(jax_encode, "load_convnext_tower", lambda config: (None, None, None))
    expected = JaxEncoder(jcfg, batch_size=batch).batch_size
    assert expected == (batch if n == 1 else max(batch, n) // n * n)
    assert _Encoder(cfg, batch_size=batch, device=["cpu"] * n).batch_size == expected


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_replicas_are_bit_equal_to_one_device(pngs, program, n):
    one, _ = store(pngs, program, 1)
    ours, _ = store(pngs, program, n)
    assert np.abs(ours - one).max() <= SHARD_RTOL * np.abs(one).max()


def test_replicas_on_one_device_share_its_module(pngs):
    _jcfg, cfg = configs(pngs[2], os.path.join(pngs[0], "unused"), {})
    encoder = _Encoder(cfg, batch_size=5, device=["cpu", "cpu", "cpu"])
    assert encoder.batch_size == 3 and encoder.devices == [torch.device("cpu")] * 3
    assert all(m is encoder.module for m in encoder._replicas())


# ----------------------------------------------------------------------
# ranks against one process


def tree_and_studies(root):
    """The image fixture tree with one PNG overwritten by garbage, and the
    post-translation CSV of its studies plus a missing one."""
    base, annotated, lists, _ = build_image_label_tree(root, n_benign=3, n_malignant=3,
                                                       image_size=36, feature_store=False)
    studies = sorted(os.path.join(base, shard, pid, "st02") for shard in os.listdir(base)
                     for pid in os.listdir(os.path.join(base, shard)))
    corrupt = os.path.join(studies[1], sorted(os.listdir(studies[1]))[0])
    with open(corrupt, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    studies.append(os.path.join(base, "02", "02999999", "st02"))  # missing
    rows = [{"patient_id": os.path.basename(os.path.dirname(p)), "study_id": "st02",
             "is_malig": str(i % 2), "image_impression": f"Impression {i}.",
             "image_description": f"Report {i}.", "study_path": p}
            for i, p in enumerate(studies)]
    post = os.path.join(root, "postprocessed_tr_dataset.csv")
    pd.DataFrame(rows).to_csv(post, encoding="latin1")
    return base, annotated, lists, corrupt, studies[-1], post


def argvs(root, tree, weights, out):
    base, annotated, lists, _corrupt, _missing, post = tree
    common = [f"networks.image_encoder.convnext_tiny_clf_path={weights}",
              "networks.image_encoder.config={micro: true, in_channels: 1}"]
    images = [f"hydra.run.dir={out}/run", f"base.features_export_dir={out}/images",
              f"dataset.config.base_dataset_path={base}",
              f"dataset.config.annotated_dataset_path={annotated}",
              f"dataset.config.lists_dataset_path={lists}", *common]
    studies = [f"hydra.run.dir={out}/run", f"base.features_export_dir={out}/studies",
               f"dataset.config.post_translation_dataset_path={post}",
               "dataset.config.post_translation_fileid=fixture", "extract_features=true",
               "dataset.config.concatenate_features_method=avgpool", *common]
    return images, studies


def files_of(root):
    out = {}
    for r, _d, files in os.walk(root):
        for name in files:
            path = os.path.join(r, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_two_ranks_write_the_one_process_store(pngs, tmp_path, monkeypatch):
    """Both runs write into the same store directory (the table holds its
    paths), one after the other; each writes its table under its own cwd."""
    tree = tree_and_studies(str(tmp_path / "tree"))
    out, single, ranks = tmp_path / "out", tmp_path / "single", tmp_path / "ranks"
    for cwd in (single, ranks):
        cwd.mkdir()
    images, studies = argvs(str(tmp_path), tree, pngs[2], str(out))
    monkeypatch.chdir(single)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the CPU's sums follow the thread count
    try:
        assert encode_images.main(["--device", "cpu", *images]) == 0
        assert encode_studies.main(["--device", "cpu", *studies]) == 0
    finally:
        torch.set_num_threads(threads)
    shutil.move(str(out), str(single / "store"))

    run_ranks(2, f"""
        os.chdir({str(ranks)!r})
        from mmgclip_tpu_torch import encode_images, encode_studies
        assert encode_images.main(["--device", "cpu", *{images!r}]) == 0
        os.environ["MASTER_ADDR"] = "file://" + os.path.join(tmp, "pg_studies")
        assert encode_studies.main(["--device", "cpu", *{studies!r}]) == 0
    """, tmp_path, torchrun=True)

    for kind in ("images", "studies"):
        ours, theirs = files_of(out / kind), files_of(single / "store" / kind)
        # failed.txt: the same entries; two ranks may append them in either order
        entries = [sorted(files.pop("failed.txt").decode().split("\n\n")) for files in (ours, theirs)]
        assert entries[0] == entries[1], kind
        assert sorted(ours) == sorted(theirs) and ours == theirs, kind
    assert len(create_dataset_path(str(out / "images"))) == 5  # six images, one corrupt
    assert (out / "images" / "failed.txt").read_text().split("\n")[0::3] == [tree[3], ""]
    failed = (out / "studies" / "failed.txt").read_text().split("\n")[0::3]
    assert sorted(failed) == sorted([tree[3], tree[4], ""])
    final = os.path.join("data", "fixture", "final_reports_dataset.csv")
    assert (ranks / final).read_bytes() == (single / final).read_bytes()


# ----------------------------------------------------------------------
# errors


def test_local_devices_without_a_card_raise(monkeypatch):
    assert local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        local_devices()
    cfg = compose(CONFIGS, "train_binary_class_clf", [])
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _Encoder(cfg, device=None)

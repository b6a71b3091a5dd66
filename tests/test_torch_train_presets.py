"""The two other stock training presets and the third loss, end to end
against the JAX package on one seeded fixture.

``train_multi_class_clf`` (the ``MassShapeLabels`` label dataset and metric),
``train_prompt_clf`` (report-sentence prompts; benign/malignant and mass
shape metrics) and ``train_binary_class_clf loss=averaged_medical_clip``
each train for 3 epochs in both packages from the same initial tree, with
each preset's own dropout (the port draws JAX's masks).  The fixture's mass
shapes are rewritten to cycle through oval, round and irregular, so the
validation's ``MassShapeLabels`` branch (``training/experiment.py``) scores
shape classes every epoch (``auc/val/shapes``).  Held: every per-epoch scalar of the run (losses,
learning rate, validation metrics) within 1e-5 relative, and the
``results.json`` of ``test()`` equal.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import train as jax_train
from fixtures import build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.config import save_snapshot as jax_save_snapshot
from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP
from mmgclip_tpu_torch import train as port_train
from mmgclip_tpu_torch.config import compose, save_snapshot
from mmgclip_tpu_torch.utils.tb import read_scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
SCALAR_RTOL = 1e-5
EPOCHS = 3
SHAPES = ("Oval", "Round", "Irregular")
CASES = {
    "multi_class": ("train_multi_class_clf", []),
    "prompt": ("train_prompt_clf", []),
    "averaged_medical_clip": ("train_binary_class_clf", ["loss=averaged_medical_clip"]),
}


def vary_mass_shapes(annotated):
    """Cycle every mass region's shape through ``SHAPES`` in file order."""
    masses = 0
    for path in sorted(glob.glob(os.path.join(annotated, "*", "*.json"))):
        with open(path) as fh:
            annotation = json.load(fh)
        for image in annotation.values():
            for region in image["regions"].values():
                if region["is_mass"]:
                    region["properties"]["mass_shape"] = SHAPES[masses % len(SHAPES)]
                    masses += 1
        with open(path, "w") as fh:
            json.dump(annotation, fh)
    return masses


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_presets")
    paths = build_image_label_tree(str(root / "data"), n_benign=18, n_malignant=18, separable=True)
    assert vary_mass_shapes(paths[1]) >= 2 * len(SHAPES)
    return root, paths


def overrides(paths, run_dir, text_path, extra):
    base, annotated, lists, features = paths
    return [
        f"dataset.config.base_dataset_path={base}",
        f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}",
        f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        f"networks.text_encoder.weights_path={text_path}",
        "networks.text_encoder.config={hidden_size: 64, num_hidden_layers: 2, "
        "num_attention_heads: 4, intermediate_size: 128, max_position_embeddings: 64}",
        "projection=2xLinear256",
        "tokenizer.config.sequence_length=32",
        f"scheduler.config.epochs={EPOCHS}",
        "dataloader.train.batch_size=4",
        "dataloader.valid.batch_size=2",
        "dataloader.test.batch_size=2",
        *extra,
    ]


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(tree, request):
    root, paths = tree
    name, extra = CASES[request.param]
    text_path = str(root / f"{request.param}_text.msgpack")
    jax_dir, port_dir = root / f"{request.param}_jax", root / f"{request.param}_port"
    jcfg = jax_compose(CONFIGS, name, overrides(paths, jax_dir, text_path, extra),
                       run_dir=str(jax_dir))
    tokenizer = JaxTokenizer.from_pretrained(jcfg.tokenizer.config.tokenizer_name,
                                             sequence_length=32)
    model = JaxMMGCLIP(jcfg, seed=int(jcfg.base.seed), vocab_size=tokenizer.vocab_size)
    with open(text_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(model.text_variables)))
    init_params = jax.device_get(model.trainable_params)
    jax_save_snapshot(jcfg, str(jax_dir))
    jax_train.run(jcfg)

    cfg = compose(CONFIGS, name, overrides(paths, port_dir, text_path, extra), run_dir=str(port_dir))
    save_snapshot(cfg, str(port_dir))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the cores
    try:
        port_train.run(cfg, device="cpu", init_params=init_params)
    finally:
        torch.set_num_threads(threads)
    return {"case": request.param, "jax": jcfg, "port": cfg}


def _results(cfg):
    with open(os.path.join(cfg.base.export_dir, "results", "results.json")) as fh:
        return json.load(fh)


def test_preset_matches_jax(runs):
    theirs = read_scalars(runs["jax"].base.tensorboard_export_dir)
    ours = read_scalars(runs["port"].base.tensorboard_export_dir)
    assert set(ours) == set(theirs)
    for tag in ("loss/train", "loss/val"):
        assert len(ours[tag]) == EPOCHS, tag
    for tag, values in theirs.items():
        if tag.startswith("throughput/") or tag == "epoch_time_s":
            continue  # host clocks
        np.testing.assert_allclose(ours[tag], values, rtol=SCALAR_RTOL, err_msg=tag)
    if runs["case"] != "averaged_medical_clip":
        # the shapes branch scored every epoch: the validation rows held at
        # least two shape classes (a class scores only beside another)
        assert len(ours.get("auc/val/shapes", [])) == EPOCHS, sorted(ours)
    assert _results(runs["port"]) == _results(runs["jax"])

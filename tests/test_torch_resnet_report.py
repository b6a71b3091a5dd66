"""``generate_report`` over a ResNet-50-family run, the port against the JAX
package on the same run.

One run of ``train_binary_class_clf`` with ``networks=clip_resnet50_bert``
(the micro towers) is trained in the port; its config points the ConvNeXt
encode tower at flax bytes of the JAX package's micro tower.  Both packages'
``generate_report`` then read that run directory, encode the PNG of one
image (and the views of one exam) through the ConvNeXt tower, re-encode the
768-d feature through the ResNet, and must print the same bytes.
"""

import os
import sys

import jax
import pytest
from flax import serialization

import generate_report as jax_generate_report
from fixtures import build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.ingest.encode import load_convnext_tower as jax_load_convnext_tower
from mmgclip_tpu_torch import generate_report
from mmgclip_tpu_torch import train as port_train
from mmgclip_tpu_torch.config import compose, save_snapshot
from torch_resnet import CONFIGS, overrides, write_text_tower

IMAGE_ID = "p0200000102cr"   # patient 02000001, study 02: the fixture's second benign image
EXAM_ID = "0210000302"       # patient 02100003, study 02


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("resnet_report")
    tree = build_image_label_tree(str(root / "data"), n_benign=8, n_malignant=8, image_size=48,
                                  separable=True)
    text_path, convnext_path = str(root / "text_tower.msgpack"), str(root / "convnext_micro.npz")
    run = root / "run"
    args = overrides(tree, run, text_path, convnext_path) + ["scheduler.config.epochs=2"]
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", args, run_dir=str(run))
    init_params = write_text_tower(jcfg, text_path)
    _module, convnext_params, _cn = jax_load_convnext_tower(jcfg)
    with open(convnext_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(convnext_params)))
    cfg = compose(CONFIGS, "train_binary_class_clf", args, run_dir=str(run))
    save_snapshot(cfg, str(run))
    port_train.run(cfg, device="cpu", init_params=init_params)
    return str(run)


@pytest.mark.parametrize("flag,value", [("--image_id", IMAGE_ID), ("--exam_id", EXAM_ID)])
def test_generate_report_prints_the_jax_bytes(run_dir, flag, value, capsys, monkeypatch):
    capsys.readouterr()
    decisions, text = generate_report.main(["--experiment_path", run_dir, flag, value, "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["generate_report.py", "--experiment_path", run_dir, flag, value])
    jax_generate_report.main()
    theirs = capsys.readouterr().out.splitlines()[-1]
    assert ours.encode() == theirs.encode() == f"Generated Report:  {text}".encode()
    assert decisions and text
    assert not os.path.exists(os.path.join(run_dir, "failed_inference.txt"))

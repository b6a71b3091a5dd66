"""The exam-report family end to end in the port against the JAX package.

Training: both packages run ``train.run`` on ``train_exam_reports_clf``
(``StudyReportDataset``, GTR prompts, the eval dataset ``ImageLabelDataset``,
so no test split and no ``test()``) with a 2-layer, 64-wide BERT (sequence
32), dropout 0, on the separable study fixture, under ``CLIPLoss`` and under
``MMGCLIPLoss`` (the impression bank's T2T term).  The frozen text tower's
flax bytes go to both through ``networks.text_encoder.weights_path`` and the
JAX model's initial trainable tree to the port.  Held: per-epoch train and
validation losses within 1e-5 relative, the validation AUCs (malignancy,
mass shape, BI-RADS from ``prompt_labels``) within 1e-5, the best
checkpoint's params within 1e-5, and neither package writing a
``results.json`` (``test()`` is skipped in both).

Encoding: the port's ``python -m mmgclip_tpu_torch.encode_studies
extract_features=true`` against the root ``encode_studies.extract`` on a
micro-tower study tree with one missing study: ``final_reports_dataset.csv``
byte-equal, ``failed.txt`` equal, study vectors within 1e-5.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
from flax import serialization

import encode_studies as jax_encode_studies
import train as jax_train
from fixtures import build_image_label_tree, build_study_report_fixture
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.config import save_snapshot as jax_save_snapshot
from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP
from mmgclip_tpu.models.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from mmgclip_tpu.models.convnext import init_convnext
from mmgclip_tpu_torch import encode_studies
from mmgclip_tpu_torch import train as port_train
from mmgclip_tpu_torch.config import compose, save_snapshot
from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
from mmgclip_tpu_torch.utils.tb import read_scalars
from mmgclip_tpu_torch.weights import flatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
EPOCHS = 3


def overrides(data, run_dir, text_path, loss):
    reports_csv, gtr_csv, features = data
    return [
        f"dataset.config.final_reports_dataset_path={reports_csv}",
        f"dataset.config.gt_path={gtr_csv}",
        f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        f"networks.text_encoder.weights_path={text_path}",
        "networks.text_encoder.config={vocab_size: 4096, hidden_size: 64, num_hidden_layers: 2, "
        "num_attention_heads: 4, intermediate_size: 128, max_position_embeddings: 64}",
        "networks.dropout.config.dropout=0.0",
        "tokenizer.config.sequence_length=32",
        f"scheduler.config.epochs={EPOCHS}",
        "dataloader.train.batch_size=4",
        "dataloader.valid.batch_size=4",
        f"loss={loss}",
        # reports + prompts under MMGCLIPLoss, prompts only (the config's) under CLIPLoss
        f"dataset.config.use_gtr_prompts_only={'false' if loss == 'mmgclip' else 'true'}",
    ]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("exam_data")
    return build_study_report_fixture(str(root), n_studies=40, separable=True)


@pytest.fixture(scope="module", params=["clip", "mmgclip"])
def runs(request, data, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"exam_{request.param}")
    text_path = str(root / "text_tower.msgpack")
    jax_dir, port_dir = root / "jax_run", root / "port_run"
    jcfg = jax_compose(CONFIGS, "train_exam_reports_clf",
                       overrides(data, jax_dir, text_path, request.param), run_dir=str(jax_dir))
    tokenizer = JaxTokenizer.from_pretrained(jcfg.tokenizer.config.tokenizer_name, sequence_length=32)
    model = JaxMMGCLIP(jcfg, seed=int(jcfg.base.seed), vocab_size=tokenizer.vocab_size)
    with open(text_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(model.text_variables)))
    jax_save_snapshot(jcfg, str(jax_dir))
    jax_train.run(jcfg)

    cfg = compose(CONFIGS, "train_exam_reports_clf",
                  overrides(data, port_dir, text_path, request.param), run_dir=str(port_dir))
    save_snapshot(cfg, str(port_dir))
    experiment = port_train.run(cfg, device="cpu",
                                init_params=jax.device_get(model.trainable_params))
    return {"jax": jcfg, "port": cfg, "experiment": experiment}


def test_exam_losses_and_aucs_match_jax(runs):
    mmgclip = runs["port"].loss.config.loss_name == "MMGCLIPLoss"
    assert (runs["experiment"]._impression_bank is not None) == mmgclip
    jax_scalars = read_scalars(runs["jax"].base.tensorboard_export_dir)
    port_scalars = read_scalars(runs["port"].base.tensorboard_export_dir)
    for tag in ("loss/train", "loss/val"):
        assert len(port_scalars[tag]) == EPOCHS
        np.testing.assert_allclose(port_scalars[tag], jax_scalars[tag], rtol=LOSS_RTOL, err_msg=tag)
    assert port_scalars["loss/train"][-1] < port_scalars["loss/train"][0]
    aucs = [tag for tag in jax_scalars if tag.startswith("auc/val/")]
    assert {"auc/val/malig", "auc/val/birads"} <= set(aucs)
    for tag in aucs:
        assert np.isfinite(port_scalars[tag]).all()
        np.testing.assert_allclose(port_scalars[tag], jax_scalars[tag], atol=1e-5, err_msg=tag)


def test_exam_checkpoint_params_match_jax(runs):
    paths = [os.path.join(cfg.checkpoints.checkpoints_export_dir, cfg.checkpoints.checkpoints_file_name)
             for cfg in (runs["jax"], runs["port"])]
    theirs, ours = (load_checkpoint(p) for p in paths)
    assert ours["epoch"] == theirs["epoch"]
    theirs, ours = flatten_tree(theirs["params"]), flatten_tree(ours["params"])
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, atol=PARAM_ATOL, err_msg=key)


def test_exam_family_writes_no_results_json(runs):
    """The eval dataset is not ``StudyReportDataset``: no test split, so
    ``run()`` skips ``test()`` in both packages."""
    assert runs["experiment"].test_dataloader is None
    for cfg in (runs["jax"], runs["port"]):
        assert not os.path.exists(os.path.join(cfg.base.results_export_dir, "results.json"))


# ----------------------------------------------------------------------
# encode_studies

def test_encode_studies_matches_jax(tmp_path, monkeypatch):
    base, _annotated, _lists, _features = build_image_label_tree(
        str(tmp_path / "tree"), n_benign=3, n_malignant=2, image_size=32, feature_store=False)
    study_paths = [os.path.join(base, shard, pid, "st02") for shard in sorted(os.listdir(base))
                   for pid in sorted(os.listdir(os.path.join(base, shard)))]
    study_paths.append(os.path.join(base, "02", "02999999", "st02"))  # missing: failed.txt
    rows = [{"patient_id": os.path.basename(os.path.dirname(p)), "study_id": "st02",
             "is_malig": str(i % 2), "image_impression": f"Impression {i}.",
             "image_description": f"Report {i}, é.", "study_path": p}
            for i, p in enumerate(study_paths)]
    post = tmp_path / "postprocessed_tr_dataset.csv"
    pd.DataFrame(rows).to_csv(post, encoding="latin1")

    micro = dataclasses.replace(JaxConvNeXtConfig.micro(), in_channels=1, layer_scale_init=0.5)
    _module, params = init_convnext(micro, seed=4, image_size=32)
    weights = tmp_path / "micro.npz"
    weights.write_bytes(serialization.to_bytes(jax.device_get(params)))
    store = tmp_path / "store"
    argv = [f"dataset.config.post_translation_dataset_path={post}",
            "dataset.config.post_translation_fileid=fixture",
            f"base.features_export_dir={store}",
            f"networks.image_encoder.convnext_tiny_clf_path={weights}",
            "networks.image_encoder.config={micro: true, in_channels: 1}",
            "dataset.config.concatenate_features_method=avgpool", "extract_features=true"]

    out = {}
    for side in ("jax", "port"):
        cwd = tmp_path / side
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        if side == "jax":
            jax_encode_studies.extract(jax_compose(CONFIGS, "train_exam_reports_clf", argv,
                                                   run_dir=str(cwd / "run")))
        else:
            assert encode_studies.main([*argv, f"hydra.run.dir={cwd / 'run'}", "--device", "cpu"]) == 0
        shutil.move(str(store), str(tmp_path / f"{side}_store"))
        out[side] = (cwd / "data" / "fixture" / "final_reports_dataset.csv").read_bytes()
    assert out["port"] == out["jax"]
    final = pd.read_csv(tmp_path / "port" / "data" / "fixture" / "final_reports_dataset.csv",
                        encoding="latin1", index_col=0, dtype=str)
    assert len(final) == len(study_paths) - 1
    assert all(p.startswith(str(store)) and p.endswith(".npy") for p in final["study_path"])
    failed = [(tmp_path / f"{side}_store" / "failed.txt").read_text().split("\n")[0]
              for side in ("jax", "port")]
    assert failed == [study_paths[-1]] * 2
    vectors = 0
    for r, _d, files in os.walk(tmp_path / "jax_store"):
        for name in files:
            if name.endswith(".npy"):
                theirs = np.load(os.path.join(r, name))
                rel = os.path.relpath(os.path.join(r, name), tmp_path / "jax_store")
                ours = np.load(tmp_path / "port_store" / rel)
                assert ours.shape == theirs.shape == (768,)
                np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5 * np.abs(theirs).max())
                vectors += 1
    assert vectors == len(study_paths) - 1

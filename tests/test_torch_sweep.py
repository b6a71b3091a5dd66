"""The data-efficiency sweep trained for real against the JAX tool
(``tools/data_efficiency.py``), on the CPU.

Both packages run ``--fractions 0.5 1.0`` for one epoch over one separable
store-only tree whose test split holds both classes (the shape of
``chip_smoke.py`` phase 20's sweep, at a narrow text tower), from the same
initial tree: the JAX model's seeded heads (the port's ``train.run`` takes
them as ``init_params``) and its text tower's bytes (``weights_path`` in
both).  Held: the rows (fraction, enum class, method, mean AUC) within
1e-5, so a label or prompt mapping that differed from JAX's would show; and
the p100 run re-evaluated by ``evaluate_clip`` reads its test()'s AUCs
(phase 20 holds the card's run so against the CPU).

The tree separates the classes along one direction, so the AUC sits near
0 or 1; after one epoch the heads have barely moved from their seeded
init, and which of the two it is follows that init: the rows are held to
JAX's, not to a side.  ``test_auc_orientation_follows_the_init`` shows it:
the same sweep from the heads with their image projection negated reads
1 - AUC.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from fixtures import build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP
from mmgclip_tpu_torch.evaluate_clip import main as evaluate_main
from mmgclip_tpu_torch.tools import data_efficiency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
sys.path.insert(0, os.path.join(REPO, "tools"))

import data_efficiency as jax_data_efficiency  # noqa: E402

PER_CLASS = 24  # phase 20's sweep tree
FRACTIONS = [0.5, 1.0]
AUC_ATOL = 1e-5
PORT_RUN = data_efficiency.train.run  # the port's train.run, before any test wraps it


def overrides(tree, text_path):
    base, annotated, lists_dir, features_dir = tree
    return [f"dataset.config.base_dataset_path={base}",
            f"dataset.config.annotated_dataset_path={annotated}",
            f"dataset.config.lists_dataset_path={lists_dir}",
            f"base.features_export_dir={features_dir}",
            f"networks.text_encoder.weights_path={text_path}",
            "tokenizer.config.sequence_length=32", "scheduler.config.epochs=1",
            "dataloader.train.batch_size=8", "dataloader.valid.batch_size=2",
            "dataloader.test.batch_size=2",
            "networks.text_encoder.config={vocab_size: 4096, hidden_size: 32, num_hidden_layers: 1, "
            "num_attention_heads: 2, intermediate_size: 64, max_position_embeddings: 64}"]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The tree, the overrides, the JAX initial heads and the JAX sweep's rows."""
    root = tmp_path_factory.mktemp("sweep")
    tree = build_image_label_tree(str(root / "tree"), n_benign=PER_CLASS, n_malignant=PER_CLASS,
                                  separable=True)
    text_path = str(root / "text.msgpack")
    args = overrides(tree, text_path)
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", args, run_dir=str(root / "init"))
    model = JaxMMGCLIP(jcfg, seed=int(jcfg.base.seed))
    with open(text_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(model.text_variables)))
    init_params = jax.device_get(model.trainable_params)
    rows = jax_data_efficiency.run_sweep("train_binary_class_clf", FRACTIONS, str(root / "jax"), args)
    return {"root": root, "args": args, "init": init_params, "jax_rows": rows}


def port_rows(sweep, monkeypatch, out, init_params):
    monkeypatch.setattr(data_efficiency.train, "run", lambda cfg, device=None: PORT_RUN(
        cfg, device=device, init_params=init_params))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the cores
    try:
        return data_efficiency.main(["--fractions", *map(str, FRACTIONS), "--out",
                                     str(sweep["root"] / out), "--device", "cpu", *sweep["args"]])
    finally:
        torch.set_num_threads(threads)


def key(row):
    return row["fraction"], row["enum_class"], row["method"]


def auc_rows(path):
    with open(path) as fh:
        return {(enum, method): m["mean_auc"] for enum, methods in json.load(fh).items()
                for method, m in methods.items() if isinstance(m, dict) and "mean_auc" in m}


def test_sweep_rows_equal_jax(sweep, monkeypatch):
    ours = port_rows(sweep, monkeypatch, "port", sweep["init"])
    theirs = sweep["jax_rows"]
    assert sorted(map(key, ours)) == sorted(map(key, theirs))
    assert {row["fraction"] for row in ours} == set(FRACTIONS)
    by_key = {key(row): row["mean_auc"] for row in theirs}
    for row in ours:
        assert np.isfinite(row["mean_auc"]), row
        assert row["mean_auc"] == pytest.approx(by_key[key(row)], abs=AUC_ATOL), row
    # phase 20's check on the card: the p100 run re-evaluated by
    # ``evaluate_clip`` reads the AUCs of its test()
    p100 = sweep["root"] / "port" / "p100"
    evaluate_main(["--experiment_path", str(p100), "--run_name", "replay", "--device", "cpu"])
    assert auc_rows(p100 / "replay" / "results.json") == auc_rows(p100 / "results" / "results.json")


def test_auc_orientation_follows_the_init(sweep, monkeypatch):
    ours = {key(row): row["mean_auc"] for row in
            port_rows(sweep, monkeypatch, "port_init", sweep["init"])}
    flipped_init = jax.tree_util.tree_map(np.asarray, sweep["init"])
    flipped_init["image_projection"] = jax.tree_util.tree_map(
        lambda leaf: -leaf, flipped_init["image_projection"])
    flipped = {key(row): row["mean_auc"] for row in
               port_rows(sweep, monkeypatch, "port_flipped", flipped_init)}
    assert set(flipped) == set(ours)
    for k, auc in ours.items():
        assert min(auc, 1 - auc) < 0.2, (k, auc)  # the separable direction shows
        assert flipped[k] == pytest.approx(1 - auc, abs=0.05), (k, auc, flipped[k])

"""The port's ``evaluate_cnn`` entry point against the JAX ``evaluate_cnn.run``.

One fixture tree with a stored feature store (``tests/test_entry_points.py``'s
``test_05_evaluate_cnn`` builds it so), ``evaluate_cnn_clf`` with the micro
tower; the JAX tower's seeded parameters (its classifier head included) are
written to flax bytes and both packages load them.  The results tables must
agree: the same classes in the same order, AUROC within 1e-6, NaN rows (a
class absent from the test split) in the same places.
"""

import math
import os

import jax
import pytest
import torch
from flax import serialization

import evaluate_cnn as jax_evaluate_cnn
import mmgclip_tpu
from fixtures import build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.ingest.encode import load_convnext_tower as jax_load_convnext_tower
from mmgclip_tpu_torch import evaluate_cnn
from mmgclip_tpu_torch.cli import compose_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUROC_TOL = 1e-6


def overrides(tree, weights, run_dir):
    base, annotated, lists, features = tree
    return [f"dataset.config.base_dataset_path={base}",
            f"dataset.config.annotated_dataset_path={annotated}",
            f"dataset.config.lists_dataset_path={lists}",
            f"base.features_export_dir={features}",
            f"networks.image_encoder.convnext_tiny_clf_path={weights}",
            "networks.image_encoder.config={micro: true, in_channels: 1}",
            "dataloader.test.batch_size=4",
            f"hydra.run.dir={run_dir}"]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("cnn")
    tree = build_image_label_tree(str(root), n_benign=12, n_malignant=12, image_size=32)
    jax_dir, port_dir = root / "jax_run", root / "port_run"
    weights = str(root / "convnext.npz")
    jcfg = jax_compose(os.path.join(REPO, "configs"), "evaluate_cnn_clf",
                       overrides(tree, "", jax_dir), run_dir=str(jax_dir))
    _module, params, _ = jax_load_convnext_tower(jcfg)  # the seeded init, head included
    with open(weights, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(params)))
    jcfg.networks.image_encoder.convnext_tiny_clf_path = weights

    captured = []
    original = mmgclip_tpu.Evaluator.evaluate_cnn

    def capture(self, classifier_fn):
        captured.append(original(self, classifier_fn))
        return captured[-1]

    mmgclip_tpu.Evaluator.evaluate_cnn = capture
    try:
        jax_evaluate_cnn.run(jcfg)
    finally:
        mmgclip_tpu.Evaluator.evaluate_cnn = original
    cfg = compose_run("evaluate_cnn_clf", overrides(tree, weights, port_dir), snapshot=False)
    return captured[0], evaluate_cnn.run(cfg, device="cpu"), tree, weights, root


def test_results_table_matches_jax(tables):
    theirs, ours, *_ = tables
    assert ours.field_names == theirs.field_names == ["Class", "AUROC"]
    assert [row[0] for row in ours.rows] == [row[0] for row in theirs.rows]
    assert any(not math.isnan(row[1]) for row in theirs.rows)
    for (name, a), (_name, b) in zip(ours.rows, theirs.rows):
        if math.isnan(b):
            assert math.isnan(a), name
        else:
            assert abs(a - b) <= AUROC_TOL, (name, a, b)


def test_entry_point_writes_the_ova_curves(tables):
    *_, tree, weights, root = tables
    run_dir = root / "cli_run"
    assert evaluate_cnn.main(["--device", "cpu", *overrides(tree, weights, run_dir)]) == 0
    ova = run_dir / "results" / "ova"
    assert (ova / "model_cnn_BenignMalignantDatasetLabels_ova_roc_curves.json").is_file()


def test_evaluate_cnn_needs_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cnn.main([])

"""The north-star done-check: the port's own entry points reproduce the demo
run's text artifacts from its committed checkpoint.

The demo's fixture tree is rebuilt with the ``tools/demo_run.py`` arguments;
the JAX engine of ``outputs/demo/run`` writes its tower parameters (the
seeded ConvNeXt micro tower and the frozen tiny BERT, which the checkpoint
does not hold) to flax bytes.  A run dir under ``tmp_path`` gets the demo's
snapshot, pointed at the fixture tree and at those bytes, and a copy of
``checkpoints/model.msgpack``; nothing under ``outputs/`` is written.  Then,
on ``--device cpu``:

* ``encode_images`` writes the feature store and ``evaluate_clip`` replays
  the test split: ``results/results.json`` equal to the demo's, every AUC
  and CI within 1e-5;
* ``generate_report --image_id`` reproduces ``generated_report.txt`` byte
  for byte (the decisions, and the report with ``generate_report.bug_compat``
  true and false);
* ``serve --once`` answers the request of ``served_request.json``:
  probabilities within 1e-5, ``similarities_argmax`` exact.

An exam case holds ``encode_inputs --exam_id`` against the JAX entry point's
on the same views, and an exam dir with a non-PNG sidecar fails both
packages' ``generate_report`` into ``failed_inference.txt`` with the same id
line (reference quirk: every file of the dir is encoded).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import generate_report as jax_generate_report
from fixtures import make_image_id
from mmgclip_tpu.config import recompose as jax_recompose
from mmgclip_tpu_torch import encode_images, evaluate_clip, generate_report, serve
from mmgclip_tpu_torch.config import Config, recompose, save_snapshot
from mmgclip_tpu_torch.data.paths import create_path
from torch_demo import DEMO_RUN, demo_towers

IMAGE_ID = make_image_id(2000000, 2, "cl")
TOL = 1e-5
EXAM_ID = "0200000502"  # a made-up exam (patient 02000005, study 02) of three fixture views


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("done_check"))
    (base, annotated, lists), _jax_engine, text_path, convnext_path = demo_towers(
        os.path.join(root, "data"))
    run = os.path.join(root, "run")
    cfg = recompose(DEMO_RUN)
    for key, value in (("dataset.config.base_dataset_path", base),
                       ("dataset.config.annotated_dataset_path", annotated),
                       ("dataset.config.lists_dataset_path", lists),
                       ("base.features_export_dir", os.path.join(root, "data", "encoded")),
                       ("base.export_dir", run),
                       ("base.results_export_dir", os.path.join(run, "results")),
                       ("base.tensorboard_export_dir", os.path.join(run, "runs")),
                       ("checkpoints.checkpoints_export_dir", os.path.join(run, "checkpoints")),
                       ("hydra.run.dir", run),
                       ("networks.image_encoder.convnext_tiny_clf_path", convnext_path),
                       ("networks.text_encoder.weights_path", text_path)):
        cfg.set_path(key, value)
    save_snapshot(cfg, run)
    os.makedirs(os.path.join(run, "checkpoints"))
    shutil.copy(os.path.join(DEMO_RUN, "checkpoints", "model.msgpack"),
                os.path.join(run, "checkpoints", "model.msgpack"))
    return {"root": root, "run": run, "cfg": cfg, "base": base}


def _entry_point_overrides(cfg, run_dir):
    """``key=value`` overrides that make ``train_binary_class_clf`` the demo's
    encode config (``tools/demo_run.py``'s ``make_cfg``)."""
    c = cfg.dataset.config
    return ["--device", "cpu",
            f"dataset.config.base_dataset_path={c.base_dataset_path}",
            f"dataset.config.annotated_dataset_path={c.annotated_dataset_path}",
            f"dataset.config.lists_dataset_path={c.lists_dataset_path}",
            f"base.features_export_dir={cfg.base.features_export_dir}",
            f"networks.image_encoder.convnext_tiny_clf_path={cfg.networks.image_encoder.convnext_tiny_clf_path}",
            "networks.image_encoder.config={micro: true, in_channels: 1}",
            f"hydra.run.dir={run_dir}"]


def _close(ours, theirs, path=""):
    """results.json: floats within TOL, everything else equal."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for key in theirs:
            _close(ours[key], theirs[key], f"{path}/{key}")
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _close(a, b, f"{path}/{i}")
    elif isinstance(theirs, float):
        assert abs(ours - theirs) <= TOL, (path, ours, theirs)
    else:
        assert ours == theirs, (path, ours, theirs)


def test_results_json_from_encode_images_and_evaluate_clip(demo):
    cfg = demo["cfg"]
    assert encode_images.main(_entry_point_overrides(cfg, os.path.join(demo["root"], "encode"))) == 0
    evaluate_clip.main(["--experiment_path", demo["run"], "--run_name", "results", "--device", "cpu"])
    with open(os.path.join(demo["run"], "results", "results.json")) as fh:
        ours = json.load(fh)
    with open(os.path.join(DEMO_RUN, "results", "results.json")) as fh:
        theirs = json.load(fh)
    _close(ours, theirs)


def test_generate_report_reproduces_the_demo_report(demo, capsys):
    run, cfg = demo["run"], demo["cfg"]
    argv = ["--experiment_path", run, "--image_id", IMAGE_ID, "--device", "cpu"]
    decisions, compat = generate_report.main(argv)
    assert capsys.readouterr().out.splitlines()[-1] == f"Generated Report:  {compat}"
    cfg.set_path("generate_report.bug_compat", False)
    save_snapshot(cfg, run)
    try:
        decisions_again, semantic = generate_report.main(argv)
    finally:
        del cfg["generate_report"]
        save_snapshot(cfg, run)
    assert decisions_again == decisions
    written = (f"image_id: {IMAGE_ID}\ndecisions: {json.dumps(decisions)}\n\n"
               f"[bug_compat=true]  {compat}\n[bug_compat=false] {semantic}\n")
    with open(os.path.join(DEMO_RUN, "generated_report.txt"), "rb") as fh:
        assert written.encode() == fh.read()


def test_serve_once_reproduces_the_served_request(demo, capsys):
    with open(os.path.join(DEMO_RUN, "served_request.json")) as fh:
        served = json.load(fh)
    request = dict(served["request"], paths=[create_path(IMAGE_ID, demo["base"])], id=1)
    serve.main(["--experiment_path", demo["run"], "--device", "cpu", "--once", json.dumps(request)])
    response = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert response["id"] == 1 and "error" not in response, response
    result, expected = response["result"], served["response"]
    np.testing.assert_allclose(result["classes_similarities"], expected["classes_similarities"],
                               atol=TOL, rtol=0)
    assert result["similarities_argmax"] == expected["similarities_argmax"]
    assert result["class_list"] == expected["class_list"]


def _exam_run(demo, name, sidecar):
    """A run dir whose base dataset holds one exam of three fixture views
    (and a sidecar file) -> (run dir, its config, the JAX config of it)."""
    root = os.path.join(demo["root"], name)
    base = os.path.join(root, "base")
    exam = os.path.join(base, EXAM_ID[:2], EXAM_ID[:8], f"st{EXAM_ID[8:]}")
    os.makedirs(exam)
    for patient, view in ((2000000, "cl"), (2000001, "cr"), (2100002, "ml")):
        image_id = make_image_id(patient, 2, view)
        shutil.copy(create_path(image_id, demo["base"]), os.path.join(exam, f"{image_id}.png"))
    if sidecar:
        with open(os.path.join(exam, "annotations.json"), "w") as fh:
            json.dump({"note": "not an image"}, fh)
    run = os.path.join(root, "run")
    cfg = Config(demo["cfg"].to_dict())
    cfg.dataset.config.base_dataset_path = base
    cfg.dataset.config.concatenate_features_method = "avgpool"
    save_snapshot(cfg, run)
    shutil.copytree(os.path.join(demo["run"], "checkpoints"), os.path.join(run, "checkpoints"))
    jcfg = jax_recompose(run)
    return run, cfg, jcfg


def test_exam_encode_matches_the_jax_entry_point(demo):
    _run, cfg, jcfg = _exam_run(demo, "exam", sidecar=False)
    ours = generate_report.encode_inputs(cfg, exam_id=EXAM_ID, device="cpu").numpy()
    theirs = np.asarray(jax_generate_report.encode_inputs(jcfg, exam_id=EXAM_ID))
    assert ours.shape == theirs.shape == (1, 768)
    assert np.abs(ours - theirs).max() <= 1e-4 * np.abs(theirs).max()


def test_exam_with_a_sidecar_fails_both_packages_alike(demo, monkeypatch):
    run, _cfg, _jcfg = _exam_run(demo, "exam_sidecar", sidecar=True)
    with pytest.raises(ValueError, match="is not a PNG file"):
        generate_report.main(["--experiment_path", run, "--exam_id", EXAM_ID, "--device", "cpu"])
    with open(os.path.join(run, "failed_inference.txt")) as fh:
        ours = fh.read().split("\n")
    os.remove(os.path.join(run, "failed_inference.txt"))
    monkeypatch.setattr(sys, "argv", ["generate_report.py", "--experiment_path", run,
                                      "--exam_id", EXAM_ID])
    with pytest.raises(Exception):
        jax_generate_report.main()
    with open(os.path.join(run, "failed_inference.txt")) as fh:
        theirs = fh.read().split("\n")
    assert ours[0] == theirs[0] == EXAM_ID
    assert ours[1] and theirs[1] and ours[-2:] == theirs[-2:] == ["", ""]


def test_generate_report_needs_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_report.main(["--experiment_path", DEMO_RUN, "--image_id", IMAGE_ID])

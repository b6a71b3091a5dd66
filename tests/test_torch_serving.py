"""The port's serving path against the committed demo run and the JAX engine.

The demo's fixture tree is rebuilt with the ``tools/demo_run.py`` arguments;
the JAX engine of ``outputs/demo/run`` writes its tower parameters to flax
bytes, and the port's config of the same run points at them through the two
weight-path keys.  The port's ``InferenceEngine(device="cpu")`` must then
reproduce ``served_request.json`` (probabilities within 1e-5, argmax exact)
and ``generated_report.txt`` (decisions and both texts byte for byte), and
``serve.handle`` must answer every op as the JAX ``serve.handle`` does.
"""

import base64
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import serve as jax_serve
from fixtures import make_image_id
from mmgclip_tpu_torch import serve
from mmgclip_tpu_torch.config import recompose
from mmgclip_tpu_torch.evaluation.report_text import generate_report
from mmgclip_tpu_torch.serving import InferenceEngine
from torch_demo import demo_towers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "outputs", "demo", "run")
PROB_TOL = 1e-5
FEATURE_RTOL = 1e-4


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    (base, _annotated, _lists), jax_engine, text_path, convnext_path = demo_towers(
        str(tmp_path_factory.mktemp("demo")))
    cfg = recompose(RUN)
    cfg.checkpoints.checkpoints_export_dir = os.path.join(RUN, "checkpoints")
    cfg.networks.image_encoder.convnext_tiny_clf_path = convnext_path
    cfg.networks.text_encoder.weights_path = text_path
    engine = InferenceEngine(cfg, device="cpu")
    exam_dir = os.path.join(base, "02", "02000000", "st02")
    png = os.path.join(exam_dir, f"{make_image_id(2000000, 2, 'cl')}.png")
    other = os.path.join(base, "02", "02100000", "st02", f"{make_image_id(2100000, 2, 'cl')}.png")
    yield engine, jax_engine, png, other, exam_dir
    engine.close()


def test_reproduces_the_served_request(engines):
    engine, _jax_engine, png, _other, _exam = engines
    with open(os.path.join(RUN, "served_request.json")) as fh:
        served = json.load(fh)
    result = engine.classify(engine.encode_paths([png]), served["request"]["class_list"])
    expected = served["response"]
    np.testing.assert_allclose(result["classes_similarities"], expected["classes_similarities"],
                               atol=PROB_TOL, rtol=0)
    assert result["similarities_argmax"] == expected["similarities_argmax"]
    assert result["class_list"] == expected["class_list"]


def test_reproduces_the_generated_report(engines):
    engine, _jax_engine, png, _other, _exam = engines
    with open(os.path.join(RUN, "generated_report.txt")) as fh:
        lines = fh.read().splitlines()
    feats = engine.encode_paths([png])
    decisions = engine.cascade_decisions(feats)[0]
    assert lines[1] == f"decisions: {json.dumps(decisions)}"
    compat = generate_report(decisions, rng=random.Random(42), bug_compat=True)[0]
    semantic = generate_report(decisions, rng=random.Random(42), bug_compat=False)[0]
    assert lines[3] == f"[bug_compat=true]  {compat}"
    assert lines[4] == f"[bug_compat=false] {semantic}"
    assert engine.generate_reports(feats, seed=42, bug_compat=True) == [compat]
    assert engine.generate_reports(feats, seed=42, bug_compat=False) == [semantic]


def assert_same_response(ours, theirs):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for key in theirs:
            assert_same_response(ours[key], theirs[key])
    elif isinstance(theirs, list) and theirs and isinstance(theirs[0], dict):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_same_response(a, b)
    elif isinstance(theirs, list) and theirs and isinstance(theirs[0], (list, float)):
        ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
        assert ours.shape == theirs.shape
        assert np.abs(ours - theirs).max() <= FEATURE_RTOL * max(np.abs(theirs).max(), 1.0)
    else:
        assert ours == theirs


def requests_for(png, other, exam_dir, feats):
    b64 = base64.b64encode(feats.astype("<f4").tobytes()).decode()
    prompts = ["Finding suggesting benign.", "Finding suggesting malignant."]
    return [
        {"op": "ping"},
        {"op": "encode", "paths": [png, other]},
        {"op": "classify", "paths": [png, other], "class_list": prompts},
        {"op": "classify", "features": feats.tolist(), "class_list": prompts},
        {"op": "classify", "features_b64": b64, "features_rows": len(feats), "class_list": prompts[::-1]},
        {"op": "report", "paths": [png, other], "seed": 7},
        {"op": "report", "exam_dir": exam_dir},
        {"op": "report", "features_b64": b64, "bug_compat": False},
    ]


def test_handle_matches_jax_for_every_op(engines):
    engine, jax_engine, png, other, exam_dir = engines
    feats = engine.encode_paths([png, other])
    for request in requests_for(png, other, exam_dir, feats):
        assert_same_response(serve.handle(engine, request), jax_serve.handle(jax_engine, request))
    with pytest.raises(ValueError, match="Unknown op"):
        serve.handle(engine, {"op": "nope"})
    assert serve.respond(engine, {"op": "nope", "id": 4}) == {"id": 4, "error": "Unknown op 'nope'"}


def test_handle_group_matches_jax(engines):
    engine, jax_engine, png, other, _exam = engines
    feats = engine.encode_paths([png, other])
    prompts = ["Mammogram revealed a mass.", "No findings are present."]
    for op_extra in ({"op": "classify", "class_list": prompts}, {"op": "report", "seed": 3}):
        group = [dict(op_extra, features=feats.tolist()),
                 dict(op_extra, features=np.concatenate([feats, feats * 0.5]).tolist())]
        assert_same_response(serve.handle_group(engine, group), jax_serve.handle_group(jax_engine, group))


def test_exam_encode_matches_jax(engines):
    engine, jax_engine, _png, _other, exam_dir = engines
    ours, theirs = engine.encode_exam(exam_dir), jax_engine.encode_exam(exam_dir)
    assert ours.shape == theirs.shape == (1, 768)
    assert np.abs(ours - theirs).max() <= FEATURE_RTOL * np.abs(theirs).max()


def test_engine_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = recompose(RUN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg)


def test_serve_module_once_and_stdin(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    once = subprocess.run(
        [sys.executable, "-m", "mmgclip_tpu_torch.serve", "--experiment_path", RUN,
         "--device", "cpu", "--once", json.dumps({"op": "ping", "id": 3})],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert once.returncode == 0, once.stderr
    assert json.loads(once.stdout.strip().splitlines()[-1]) == {"id": 3, "result": {"ok": True}}
    lines = subprocess.run(
        [sys.executable, "-m", "mmgclip_tpu_torch.serve", "--experiment_path", RUN, "--device", "cpu"],
        input='{"op": "ping", "id": 1}\nnot json\n\n{"op": "bad", "id": 2}\n',
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert lines.returncode == 0, lines.stderr
    out = [json.loads(line) for line in lines.stdout.strip().splitlines()]
    assert out[0] == {"id": 1, "result": {"ok": True}}
    assert out[1]["id"] is None and out[1]["error"].startswith("bad json")
    assert out[2] == {"id": 2, "error": "Unknown op 'bad'"}

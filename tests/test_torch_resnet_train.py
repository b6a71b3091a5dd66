"""The ResNet-50 family end to end in the port against the JAX package.

Both packages train ``train_binary_class_clf`` with
``networks=clip_resnet50_bert`` (the micro tower: stages ``(1, 1, 1, 1)`` at
width 8, pooled to 256; a one-layer, 32-wide BERT) for 3 epochs on one
seeded fixture of separable 768-d features, from the JAX model's initial
trainable tree.  Held:

* per-epoch train and validation losses within 1e-5 relative, the final
  params within 1e-5, and in both packages the stem and ``layer1`` -
  ``layer3`` bit-unchanged while ``layer4`` and the heads moved;
* ``results.json`` of ``test()`` within 1e-5, and ``evaluate_clip``
  reproducing the port's;
* ``serve --once`` ``classify`` on the trained run against the JAX engine,
  and the unix-socket front-end (pipelined ``classify`` and ``report``
  requests) against the JAX server's ``handle`` on the JAX run;
* resume across packages, the masked optimizer chain
  (``optax.chain(optax.masked(adamw), optax.masked(set_to_zero))``) and the
  dropout key crossing: each unbroken run keeps its checkpoint after the
  second epoch aside, the other package resumes from that file for the
  third epoch and ends where its own unbroken run ends (losses within 1e-5
  relative, params within 1e-5, the stem and ``layer1`` - ``layer3``
  bit-equal).

``generate_report`` is held in ``test_torch_resnet_report.py``.
"""

import base64
import json
import os
import shutil

import jax
import numpy as np
import pytest

import serve as jax_serve
import train as jax_train
from fixtures import build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.config import save_snapshot as jax_save_snapshot
from mmgclip_tpu.serving import InferenceEngine as JaxEngine
from mmgclip_tpu.training import early_stopping as jax_early_stopping
from mmgclip_tpu.training.experiment import ClassifierExperiment as JaxExperiment
from mmgclip_tpu_torch import serve
from mmgclip_tpu_torch import train as port_train
from mmgclip_tpu_torch.config import compose, save_snapshot
from mmgclip_tpu_torch.evaluate_clip import evaluate
from mmgclip_tpu_torch.models.resnet import ResNet50Encoder
from mmgclip_tpu_torch.serving import InferenceEngine
from mmgclip_tpu_torch.training import early_stopping
from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
from mmgclip_tpu_torch.utils.tb import read_scalars
from mmgclip_tpu_torch.weights import clip_params_tree, flatten_tree
from test_torch_serve_socket import assert_same, exchange, serving
from torch_resnet import CONFIGS, EPOCHS, TOL, ckpt, close_results, overrides, write_text_tower

RESUME_AT = 2  # epochs before the checkpoint the other package resumes from


def _keeping_epoch(module, epoch, keep):
    """``module.save_checkpoint`` that also copies the file written after
    ``epoch`` (0-based) to ``keep``."""
    save = module.save_checkpoint

    def wrapped(path, *args, **kwargs):
        out = save(path, *args, **kwargs)
        if kwargs.get("epoch") == epoch:
            shutil.copy(path, keep)
        return out
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resnet_slice")
    tree = build_image_label_tree(str(root / "data"), n_benign=12, n_malignant=12, separable=True)
    text_path = str(root / "text_tower.msgpack")
    jax_dir, port_dir = root / "jax_run", root / "port_run"
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", overrides(tree, jax_dir, text_path),
                       run_dir=str(jax_dir))
    init_params = write_text_tower(jcfg, text_path)
    jax_save_snapshot(jcfg, str(jax_dir))
    kept = {package: str(root / f"{package}_epoch{RESUME_AT}.msgpack") for package in ("jax", "port")}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_early_stopping, "save_checkpoint",
                      _keeping_epoch(jax_early_stopping, RESUME_AT - 1, kept["jax"]))
        patch.setattr(early_stopping, "save_checkpoint",
                      _keeping_epoch(early_stopping, RESUME_AT - 1, kept["port"]))
        jax_train.run(jcfg)
        cfg = compose(CONFIGS, "train_binary_class_clf", overrides(tree, port_dir, text_path),
                      run_dir=str(port_dir))
        save_snapshot(cfg, str(port_dir))
        experiment = port_train.run(cfg, device="cpu", init_params=init_params)
    return {"jax": jcfg, "port": cfg, "experiment": experiment, "init": flatten_tree(init_params),
            "init_tree": init_params, "root": root, "tree": tree, "text_path": text_path,
            "kept": kept}


def test_losses_match_jax(runs):
    assert isinstance(runs["experiment"].model.image_module, ResNet50Encoder)
    want = read_scalars(runs["jax"].base.tensorboard_export_dir)
    got = read_scalars(runs["port"].base.tensorboard_export_dir)
    for tag in ("loss/train", "loss/val"):
        assert len(got[tag]) == EPOCHS
        np.testing.assert_allclose(got[tag], want[tag], rtol=TOL, err_msg=tag)
    assert got["loss/val"] == sorted(got["loss/val"], reverse=True)  # the best checkpoint is the last
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-12)


def test_params_match_and_only_layer4_and_the_heads_moved(runs):
    live = flatten_tree(clip_params_tree(runs["experiment"].model))
    jax_best = flatten_tree(load_checkpoint(ckpt(runs["jax"]))["params"])
    assert set(live) == set(jax_best) == set(runs["init"])
    for key, value in jax_best.items():
        np.testing.assert_allclose(live[key], value, atol=TOL, err_msg=key)
        frozen = key.startswith("image_encoder.") and not key.startswith("image_encoder.layer4")
        for params in (live, jax_best):
            assert np.array_equal(params[key], runs["init"][key]) == frozen, key


def _results(cfg, name="results"):
    with open(os.path.join(cfg.base.export_dir, name, "results.json")) as fh:
        return json.load(fh)


def test_results_and_evaluate_clip_match_jax(runs):
    ours = _results(runs["port"])
    close_results(ours, _results(runs["jax"]))
    assert ours["BenignMalignantDatasetLabels"]["zeroshot_label_prompt"]["auc_ci_mean"] is not None
    evaluate(str(runs["port"].base.export_dir), "replay", device="cpu")
    assert _results(runs["port"], "replay") == ours


@pytest.fixture(scope="module")
def jax_engine(runs):
    return JaxEngine.from_experiment(str(runs["jax"].base.export_dir))


def test_serve_once_classify_matches_jax(runs, jax_engine, capsys):
    feats = np.random.default_rng(7).standard_normal((3, 768)).astype("<f4")
    prompts = ["Finding suggesting benign.", "Finding suggesting malignant."]
    request = {"op": "classify", "features_b64": base64.b64encode(feats.tobytes()).decode(),
               "features_rows": 3, "class_list": prompts, "id": 12}
    capsys.readouterr()
    serve.main(["--experiment_path", str(runs["port"].base.export_dir), "--device", "cpu",
                "--once", json.dumps(request)])
    response = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert response["id"] == 12 and "error" not in response, response
    want = jax_engine.classify(feats, prompts)
    np.testing.assert_allclose(response["result"]["classes_similarities"],
                               np.asarray(want["classes_similarities"]), atol=TOL, rtol=0)
    assert response["result"]["similarities_argmax"] == list(np.asarray(want["similarities_argmax"]))


def test_socket_front_end_answers_as_the_jax_server(runs, jax_engine, tmp_path):
    feats = np.random.default_rng(9).standard_normal((2, 768)).astype("<f4")
    b64 = base64.b64encode(feats.tobytes()).decode()
    prompts = ["Finding suggesting benign.", "Finding suggesting malignant."]
    requests = [{"op": "classify", "features": feats.tolist(), "class_list": prompts, "id": "clf"},
                {"op": "classify", "features_b64": b64, "features_rows": 2, "class_list": prompts,
                 "id": "clf-b64"},
                {"op": "report", "features_b64": b64, "features_rows": 2, "seed": 3, "id": "report"}]
    engine = InferenceEngine.from_experiment(str(runs["port"].base.export_dir), device="cpu")
    try:
        with serving(serve.serve_socket, engine, path=str(tmp_path / "s.sock")) as address:
            ours = exchange(address, requests)
    finally:
        engine.close()
    theirs = [jax_serve.handle(jax_engine, request) for request in requests]
    for mine, want, request in zip(ours, theirs, requests):
        assert mine["id"] == request["id"] and "error" not in mine, mine
        assert_same(mine["result"], want)


# ----------------------------------------------------------------------
# resume across packages

def _on_the_mesh(resume):
    """The JAX ``resume()``, then the restored optimizer state placed on the
    trainer's mesh (as ``test_torch_train_e2e.py`` places it)."""
    def wrapped(self):
        found = resume(self)
        if found:
            self.opt_state = jax.device_put(self.opt_state, self._replicated)
        return found
    return wrapped


@pytest.fixture(scope="module")
def resumed(runs):
    """Each package resumed for the third epoch from the other's kept file;
    no ``test()`` (the runs are compared on losses and checkpoints)."""
    out = {}
    for package, source in (("port", "jax"), ("jax", "port")):
        run_dir = runs["root"] / f"{package}_resumed"
        (run_dir / "checkpoints").mkdir(parents=True)
        shutil.copy(runs["kept"][source], run_dir / "checkpoints" / "model.msgpack")
        args = overrides(runs["tree"], run_dir, runs["text_path"]) + [
            "base.resume=true", "dataset.eval.enum_classes=[]"]
        if package == "port":
            cfg = compose(CONFIGS, "train_binary_class_clf", args, run_dir=str(run_dir))
            save_snapshot(cfg, str(run_dir))
            port_train.run(cfg, device="cpu", init_params=runs["init_tree"])
        else:
            cfg = jax_compose(CONFIGS, "train_binary_class_clf", args, run_dir=str(run_dir))
            jax_save_snapshot(cfg, str(run_dir))
            with pytest.MonkeyPatch.context() as patch:
                patch.setattr(JaxExperiment, "resume", _on_the_mesh(JaxExperiment.resume))
                jax_train.run(cfg)
        out[package] = cfg
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_in_the_other_package_matches_an_unbroken_run(runs, resumed, direction):
    source, target = direction.split("_to_")
    assert load_checkpoint(runs["kept"][source])["epoch"] == RESUME_AT - 1
    straight, after = runs[target], resumed[target]
    want = read_scalars(straight.base.tensorboard_export_dir)
    got = read_scalars(after.base.tensorboard_export_dir)
    assert want["loss/val"] == sorted(want["loss/val"], reverse=True)  # the best checkpoint is the last
    for tag in ("loss/train", "loss/val"):
        assert len(got[tag]) == EPOCHS - RESUME_AT, tag
        np.testing.assert_allclose(got[tag], want[tag][RESUME_AT:], rtol=TOL, err_msg=tag)
    ours, theirs = (flatten_tree(load_checkpoint(ckpt(cfg))["params"]) for cfg in (after, straight))
    assert load_checkpoint(ckpt(after))["epoch"] == EPOCHS - 1
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, atol=TOL, err_msg=key)
        if key.startswith("image_encoder.") and not key.startswith("image_encoder.layer4"):
            np.testing.assert_array_equal(ours[key], value, err_msg=key)

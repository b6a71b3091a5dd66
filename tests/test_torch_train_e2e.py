"""The port's training slice (train -> test() -> evaluate_clip) against the
JAX package's on the same seeded fixture.

Both packages train the ``train_binary_class_clf`` preset with a 2-layer,
64-wide BERT and a 2-layer projection head (dropout 0) for 3 epochs on the
same separable feature store.  The frozen text tower's flax bytes go to both
through ``networks.text_encoder.weights_path``, and the JAX model's initial
trainable tree goes to the port through ``weights``.  Held:

* per-epoch train and validation losses within 1e-5 relative;
* the best checkpoint's params within 1e-5, each package reading the other's
  file;
* ``results.json`` of ``test()`` equal (all three evaluation methods), and
  ``evaluate_clip`` on the port's run directory reproducing it.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
from flax import serialization

import train as jax_train
from fixtures import build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.config import save_snapshot as jax_save_snapshot
from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP
from mmgclip_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from mmgclip_tpu_torch import train as port_train
from mmgclip_tpu_torch.config import compose
from mmgclip_tpu_torch.evaluate_clip import evaluate
from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
from mmgclip_tpu_torch.utils.tb import read_scalars
from mmgclip_tpu_torch.weights import flatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
EPOCHS = 3


def overrides(tree, run_dir, text_path):
    base, annotated, lists, features = tree
    return [
        f"dataset.config.base_dataset_path={base}",
        f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}",
        f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        f"networks.text_encoder.weights_path={text_path}",
        "networks.text_encoder.config={hidden_size: 64, num_hidden_layers: 2, "
        "num_attention_heads: 4, intermediate_size: 128, max_position_embeddings: 64}",
        "networks.dropout.config.dropout=0.0",
        "projection=2xLinear256",
        "tokenizer.config.sequence_length=32",
        f"scheduler.config.epochs={EPOCHS}",
        "dataloader.train.batch_size=4",
        "dataloader.valid.batch_size=2",
        "dataloader.test.batch_size=2",
        "dataset.eval.method=[zeroshot, zeroshot_label_prompt, confustion_matrix]",
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_e2e")
    tree = build_image_label_tree(str(root / "data"), n_benign=12, n_malignant=12,
                                  separable=True)
    text_path = str(root / "text_tower.msgpack")

    jax_dir, port_dir = root / "jax_run", root / "port_run"
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf",
                       overrides(tree, jax_dir, text_path), run_dir=str(jax_dir))
    tokenizer = JaxTokenizer.from_pretrained(jcfg.tokenizer.config.tokenizer_name,
                                             sequence_length=32)
    model = JaxMMGCLIP(jcfg, seed=int(jcfg.base.seed), vocab_size=tokenizer.vocab_size)
    with open(text_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(model.text_variables)))
    init_params = jax.device_get(model.trainable_params)

    jax_save_snapshot(jcfg, str(jax_dir))
    jax_train.run(jcfg)

    cfg = compose(CONFIGS, "train_binary_class_clf", overrides(tree, port_dir, text_path),
                  run_dir=str(port_dir))
    from mmgclip_tpu_torch.config import save_snapshot

    save_snapshot(cfg, str(port_dir))
    experiment = port_train.run(cfg, device="cpu", init_params=init_params)
    return {"jax": jcfg, "port": cfg, "experiment": experiment, "model": model}


def test_epoch_losses_match_jax(runs):
    jax_scalars = read_scalars(runs["jax"].base.tensorboard_export_dir)
    port_scalars = read_scalars(runs["port"].base.tensorboard_export_dir)
    for tag in ("loss/train", "loss/val"):
        assert len(port_scalars[tag]) == EPOCHS
        np.testing.assert_allclose(port_scalars[tag], jax_scalars[tag], rtol=LOSS_RTOL, err_msg=tag)
    assert port_scalars["loss/train"][-1] < port_scalars["loss/train"][0]
    np.testing.assert_allclose(port_scalars["lr"], jax_scalars["lr"], rtol=1e-12)


def _ckpt(cfg):
    return os.path.join(cfg.checkpoints.checkpoints_export_dir, cfg.checkpoints.checkpoints_file_name)


def test_checkpoints_cross_both_ways(runs):
    jax_path, port_path = _ckpt(runs["jax"]), _ckpt(runs["port"])
    template = runs["model"].trainable_params
    # the JAX loader reads the port's file; the port reads the JAX file
    jax_reads_port = flatten_tree(jax.device_get(jax_load_checkpoint(port_path, template)["params"]))
    port_reads_jax = flatten_tree(load_checkpoint(jax_path)["params"])
    port_reads_port = flatten_tree(load_checkpoint(port_path)["params"])
    assert set(jax_reads_port) == set(port_reads_jax) == set(port_reads_port)
    for key in port_reads_jax:
        np.testing.assert_array_equal(jax_reads_port[key], port_reads_port[key])
        np.testing.assert_allclose(port_reads_port[key], port_reads_jax[key], atol=PARAM_ATOL,
                                   err_msg=key)
    with open(jax_path, "rb") as fh:
        jax_state = pickle.load(fh)
    with open(port_path, "rb") as fh:
        port_state = pickle.load(fh)
    for key in ("epoch", "counter"):
        assert port_state[key] == jax_state[key]
    np.testing.assert_allclose(port_state["val_loss"], jax_state["val_loss"], rtol=LOSS_RTOL)
    assert port_state["torch_opt_state"] is not None and port_state["torch_rng_state"]


def test_final_params_match_jax_run(runs):
    """The port's live params after the last epoch against the JAX run's best
    checkpoint: the losses fall every epoch here, so the best is the last."""
    assert read_scalars(runs["port"].base.tensorboard_export_dir)["loss/val"] == sorted(
        read_scalars(runs["port"].base.tensorboard_export_dir)["loss/val"], reverse=True)
    from mmgclip_tpu_torch.weights import clip_params_tree

    live = flatten_tree(clip_params_tree(runs["experiment"].model))
    jax_best = flatten_tree(load_checkpoint(_ckpt(runs["jax"]))["params"])
    for key, value in jax_best.items():
        np.testing.assert_allclose(live[key], value, atol=PARAM_ATOL, err_msg=key)


def _results(cfg, name="results"):
    with open(os.path.join(cfg.base.export_dir, name, "results.json")) as fh:
        return json.load(fh)


def test_results_json_equal(runs):
    ours, theirs = _results(runs["port"]), _results(runs["jax"])
    assert ours == theirs
    methods = ours["BenignMalignantDatasetLabels"]
    assert set(methods) == {"zeroshot", "zeroshot_label_prompt", "confusion_matrix"}
    assert methods["zeroshot_label_prompt"]["auc_ci_mean"] is not None
    assert os.path.isfile(os.path.join(runs["port"].base.results_export_dir, "results.txt"))


def test_evaluate_clip_reproduces_results(runs):
    run_dir = runs["port"].base.export_dir
    evaluate(str(run_dir), "results_replay", device="cpu")
    assert _results(runs["port"], "results_replay") == _results(runs["port"])

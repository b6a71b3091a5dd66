"""The port's training slice (train -> test() -> evaluate_clip) against the
JAX package's on the same seeded fixture.

Both packages train the ``train_binary_class_clf`` preset with a 2-layer,
64-wide BERT and a 2-layer projection head for 3 epochs on the same
separable feature store, once with dropout 0 and once with dropout 0.5 (the
port draws JAX's masks: the threefry key, split per step, and flax's
``make_rng`` fold-in).  The frozen text tower's flax bytes go to both
through ``networks.text_encoder.weights_path``, and the JAX model's initial
trainable tree goes to the port through ``weights``.  Held:

* per-epoch train and validation losses within 1e-5 relative;
* the best checkpoint's params within 1e-5, each package reading the other's
  file;
* ``results.json`` of ``test()`` equal (all three evaluation methods), and
  ``evaluate_clip`` on the port's run directory reproducing it;
* a run of two epochs in one package, resumed for the third in the other
  from its checkpoint (AdamW count, moments and hyperparams crossing), ends
  where the resuming package's unbroken run ends: the third epoch's losses
  within 1e-5 relative and the final params within 1e-5.  The dropout key
  crosses in JAX's ``rng_key`` form, so with dropout on the resumed epoch
  draws the unbroken run's masks.
"""

import json
import os
import pickle
import shutil

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
from mmgclip_tpu.training.optim import create_optimizer as jax_create_optimizer
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


def overrides(tree, run_dir, text_path, dropout):
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
        f"networks.dropout.config.dropout={dropout}",
        "projection=2xLinear256",
        "tokenizer.config.sequence_length=32",
        f"scheduler.config.epochs={EPOCHS}",
        "dataloader.train.batch_size=4",
        "dataloader.valid.batch_size=2",
        # the validation order then depends on nothing a checkpoint leaves out
        # (a shuffling loader's generator is not saved), so a resumed run's
        # validation losses are comparable with an unbroken run's
        "dataloader.valid.shuffle=false",
        "dataloader.test.batch_size=2",
        "dataset.eval.method=[zeroshot, zeroshot_label_prompt, confustion_matrix]",
    ]


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["dropout0", "dropout0.5"])
def runs(tmp_path_factory, request):
    dropout = request.param
    root = tmp_path_factory.mktemp("train_e2e")
    tree = build_image_label_tree(str(root / "data"), n_benign=12, n_malignant=12,
                                  separable=True)
    text_path = str(root / "text_tower.msgpack")

    jax_dir, port_dir = root / "jax_run", root / "port_run"
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf",
                       overrides(tree, jax_dir, text_path, dropout), run_dir=str(jax_dir))
    tokenizer = JaxTokenizer.from_pretrained(jcfg.tokenizer.config.tokenizer_name,
                                             sequence_length=32)
    model = JaxMMGCLIP(jcfg, seed=int(jcfg.base.seed), vocab_size=tokenizer.vocab_size)
    with open(text_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(model.text_variables)))
    init_params = jax.device_get(model.trainable_params)

    jax_save_snapshot(jcfg, str(jax_dir))
    jax_train.run(jcfg)

    cfg = compose(CONFIGS, "train_binary_class_clf", overrides(tree, port_dir, text_path, dropout),
                  run_dir=str(port_dir))
    from mmgclip_tpu_torch.config import save_snapshot

    save_snapshot(cfg, str(port_dir))
    experiment = port_train.run(cfg, device="cpu", init_params=init_params)
    return {"jax": jcfg, "port": cfg, "experiment": experiment, "model": model, "root": root,
            "tree": tree, "text_path": text_path, "init_params": init_params, "dropout": dropout}


def test_epoch_losses_match_jax(runs):
    jax_scalars = read_scalars(runs["jax"].base.tensorboard_export_dir)
    port_scalars = read_scalars(runs["port"].base.tensorboard_export_dir)
    for tag in ("loss/train", "loss/val"):
        assert len(port_scalars[tag]) == EPOCHS
        np.testing.assert_allclose(port_scalars[tag], jax_scalars[tag], rtol=LOSS_RTOL, err_msg=tag)
    # training moved the model: with dropout off the train loss falls; with it
    # on the train loss carries the masks' noise and the validation loss falls
    tag = "loss/train" if runs["dropout"] == 0.0 else "loss/val"
    assert port_scalars[tag][-1] < port_scalars[tag][0]
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
    assert port_state["torch_opt_state"] is not None and "torch_rng_state" not in port_state
    # the dropout key in JAX's form, advanced by as many steps in both runs
    assert port_state["rng_key"] == jax_state["rng_key"] and len(jax_state["rng_key"]) == 2


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


# ----------------------------------------------------------------------
# resume across packages (the AdamW state in both checkpoint layouts)

RESUME_AT = 2  # epochs before the checkpoint; the schedule's rate is the same for both totals


def _port_run(runs, name, extra=()):
    from mmgclip_tpu_torch.config import save_snapshot

    run_dir = runs["root"] / name
    cfg = compose(CONFIGS, "train_binary_class_clf",
                  overrides(runs["tree"], run_dir, runs["text_path"], runs["dropout"]) + list(extra),
                  run_dir=str(run_dir))
    save_snapshot(cfg, str(run_dir))
    return cfg, port_train.run(cfg, device="cpu", init_params=runs["init_params"])


def _jax_run(runs, name, extra=()):
    run_dir = runs["root"] / name
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf",
                       overrides(runs["tree"], run_dir, runs["text_path"], runs["dropout"]) + list(extra),
                       run_dir=str(run_dir))
    jax_save_snapshot(jcfg, str(run_dir))
    jax_train.run(jcfg)
    return jcfg


def _seed_checkpoint(source_cfg, target_name, runs):
    """Copy a run's best checkpoint to where ``target_name``'s run resumes from."""
    target = runs["root"] / target_name / "checkpoints"
    target.mkdir(parents=True)
    shutil.copy(_ckpt(source_cfg), target / "model.msgpack")


def _resume_on_the_mesh(resume):
    """The JAX ``resume()``, then the restored optimizer state placed on the
    trainer's mesh.  On a fresh trainer over several devices, ``resume()``
    puts each restored leaf where its init value sat, and the init's scalar
    count sits on one device, which the jitted epoch then refuses beside
    the replicated params (a fault of the JAX package, ROADMAP.md §3)."""
    def wrapped(self):
        found = resume(self)
        if found:
            self.opt_state = jax.device_put(self.opt_state, self._replicated)
        return found
    return wrapped


@pytest.fixture(scope="module")
def resumed(runs):
    """Two epochs in each package; the other package resumes for the third."""
    from mmgclip_tpu.training.experiment import ClassifierExperiment

    short = [f"scheduler.config.epochs={RESUME_AT}"]
    out = {"jax_short": _jax_run(runs, "jax_short", short),
           "port_short": _port_run(runs, "port_short", short)[0]}
    _seed_checkpoint(out["jax_short"], "port_resumed", runs)
    out["port_resumed"], out["port_resumed_experiment"] = _port_run(
        runs, "port_resumed", ["base.resume=true"])
    _seed_checkpoint(out["port_short"], "jax_resumed", runs)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ClassifierExperiment, "resume",
                      _resume_on_the_mesh(ClassifierExperiment.resume))
        out["jax_resumed"] = _jax_run(runs, "jax_resumed", ["base.resume=true"])
    return out


def test_port_opt_state_is_optax_layout(runs, resumed):
    """The port's ``opt_state`` restores through the JAX loader with its own
    template, holds the values of ``torch_opt_state``, and is byte-equal to
    what flax writes for the restored state."""
    path = _ckpt(resumed["port_short"])
    template = runs["model"].trainable_params
    cfg = runs["jax"].optimizer.config
    opt_template = jax_create_optimizer(float(cfg.learning_rate), float(cfg.weight_decay)).init(template)
    restored = jax.device_get(jax_load_checkpoint(path, template, opt_template)["opt_state"])
    with open(path, "rb") as fh:
        raw = pickle.load(fh)
    assert serialization.to_bytes(restored) == raw["opt_state"]
    ours = load_checkpoint(path)
    torch_state = ours["torch_opt_state"]
    assert int(restored.count) == int(restored.inner_state[0].count) == int(torch_state["count"])
    assert int(torch_state["count"]) > 0
    for name in ("learning_rate", "weight_decay"):
        assert np.float32(restored.hyperparams[name]) == np.float32(torch_state["hyperparams"][name])
    for slot in ("mu", "nu"):
        theirs = flatten_tree(jax.device_get(getattr(restored.inner_state[0], slot)))
        assert set(theirs) == set(torch_state[slot]) == set(ours["opt_state"][slot])
        for key, value in theirs.items():
            np.testing.assert_array_equal(value, torch_state[slot][key], err_msg=f"{slot} {key}")
            np.testing.assert_array_equal(ours["opt_state"][slot][key], value)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_in_the_other_package_matches_an_unbroken_run(runs, resumed, direction):
    source, target = direction.split("_to_")
    short, straight, after = resumed[f"{source}_short"], runs[target], resumed[f"{target}_resumed"]
    assert load_checkpoint(_ckpt(short))["epoch"] == RESUME_AT - 1, "the last epoch must be the best"
    want = read_scalars(straight.base.tensorboard_export_dir)
    got = read_scalars(after.base.tensorboard_export_dir)
    for tag in ("loss/train", "loss/val"):
        assert len(got[tag]) == EPOCHS - RESUME_AT, tag
        np.testing.assert_allclose(got[tag], want[tag][RESUME_AT:], rtol=LOSS_RTOL, err_msg=tag)
    assert load_checkpoint(_ckpt(after))["epoch"] == EPOCHS - 1
    if target == "port":
        from mmgclip_tpu_torch.weights import clip_params_tree

        got = flatten_tree(clip_params_tree(resumed["port_resumed_experiment"].model))
        want = flatten_tree(clip_params_tree(runs["experiment"].model))
    else:  # the losses fall every epoch, so the best checkpoint is the last
        got = flatten_tree(load_checkpoint(_ckpt(after))["params"])
        want = flatten_tree(load_checkpoint(_ckpt(straight))["params"])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=PARAM_ATOL, err_msg=key)

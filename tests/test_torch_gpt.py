"""The BioGPT text-tower family in the port against the JAX package.

* ``CausalTextEncoder`` at ``GPTConfig.tiny()`` width, on the JAX init
  carried across by name, matches ``mmgclip_tpu.models.gpt`` within 1e-5 on
  right-padded batches (every position, padded ones included);
* ``load_biogpt_weights`` on a tiny ``transformers.BioGptModel`` state dict
  gives the JAX loader's stacked tree, and then the same hidden states;
* ``MMGCLIP`` dispatches the causal tower names and reads its flax bytes
  through ``networks.text_encoder.weights_path``;
* the slice: JAX's and the port's ``train`` with ``networks=clip_convnext_biogpt
  tokenizer=biogpt`` (the preset's ``1xLinear512`` head) at tiny width on one
  fixture: token banks id-equal, per-epoch losses within 1e-5 (relative or
  absolute), ``results.json`` equal, then
  ``evaluate_clip`` and ``serve --once`` ``classify`` on the trained run
  against the JAX engine within 1e-5.
"""

import base64
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import train as jax_train
from fixtures import build_image_label_tree
from mmgclip_tpu.config import compose as jax_compose
from mmgclip_tpu.config import save_snapshot as jax_save_snapshot
from mmgclip_tpu.data.datasets import get_dataset as jax_get_dataset
from mmgclip_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mmgclip_tpu.models.gpt import init_gpt
from mmgclip_tpu.models.gpt import load_biogpt_weights as jax_load_biogpt_weights
from mmgclip_tpu.serving import InferenceEngine as JaxEngine
from mmgclip_tpu_torch import serve
from mmgclip_tpu_torch import train as port_train
from mmgclip_tpu_torch.config import compose, save_snapshot
from mmgclip_tpu_torch.data.datasets import get_dataset
from mmgclip_tpu_torch.evaluate_clip import evaluate
from mmgclip_tpu_torch.models.clip import MMGCLIP
from mmgclip_tpu_torch.models.gpt import CausalTextEncoder, GPTConfig, load_biogpt_weights
from mmgclip_tpu_torch.utils.tb import read_scalars
from mmgclip_tpu_torch.weights import flatten_tree, load_flax_tree, module_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TOL = 1e-5
TINY_TEXT = ("networks.text_encoder.config={hidden_size: 32, num_hidden_layers: 2, "
             "num_attention_heads: 2, intermediate_size: 64, max_position_embeddings: 64}")


def padded_batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(4, 19)).astype(np.int32)
    mask = (np.arange(19)[None, :] < np.array([19, 11, 1, 6])[:, None]).astype(np.int32)
    return ids, mask


def test_causal_tower_matches_jax_at_tiny_width():
    module, params = init_gpt(JaxGPTConfig.tiny(), seed=3)
    tower = CausalTextEncoder(GPTConfig.tiny())
    load_flax_tree(tower, jax.device_get(params)["params"])
    ids, mask = padded_batch(GPTConfig.tiny().vocab_size)
    want = np.asarray(module.apply(params, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert sorted(flatten_tree(module_tree(tower))) == sorted(
        flatten_tree(jax.device_get(params)["params"]))


def test_biogpt_weights_load_as_jax_loads_them():
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.BioGptConfig(
        vocab_size=256, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, activation_dropout=0.0)
    torch.manual_seed(0)
    state = transformers.BioGptModel(hf_config).eval().state_dict()
    module, params = init_gpt(JaxGPTConfig.tiny())
    theirs = jax.device_get(jax_load_biogpt_weights(params, state, JaxGPTConfig.tiny()))
    tower = load_biogpt_weights(CausalTextEncoder(GPTConfig.tiny()), state)
    ours = flatten_tree(module_tree(tower))
    for key, value in flatten_tree(theirs["params"]).items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    ids, mask = padded_batch(256, seed=1)
    want = np.asarray(module.apply(theirs, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["CausalTextEncoder", "BioGptEncoder", "GPTEncoder"])
def test_clip_model_dispatches_the_causal_tower(name, tmp_path):
    overrides = ["networks=clip_convnext_biogpt", f"networks.text_encoder.name={name}", TINY_TEXT]
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", overrides, run_dir=str(tmp_path))
    from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP

    jmodel = JaxMMGCLIP(jcfg, seed=0, vocab_size=300)
    path = tmp_path / "text.msgpack"
    path.write_bytes(serialization.to_bytes(jax.device_get(jmodel.text_variables)))
    cfg = compose(CONFIGS, "train_binary_class_clf",
                  overrides + [f"networks.text_encoder.weights_path={path}"], run_dir=str(tmp_path))
    model = MMGCLIP(cfg, seed=0, vocab_size=300)
    assert isinstance(model.text_module, CausalTextEncoder)
    assert model.bert_config.vocab_size == 300 and model.text_output_dimension == 32
    ids, mask = padded_batch(300, seed=2)
    tokens = {"input_ids": ids, "attention_mask": mask}
    want = np.asarray(jmodel.apply_text_tower(tokens))
    with torch.no_grad():
        got = model.apply_text_tower(tokens).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    full = compose(CONFIGS, "train_binary_class_clf", ["networks=clip_convnext_biogpt"],
                   run_dir=str(tmp_path))
    from mmgclip_tpu_torch.models.clip import _text_tower_config_from

    assert _text_tower_config_from(full, 596, GPTConfig) == GPTConfig()  # the config's 42384 wins


# ----------------------------------------------------------------------
# the slice: train -> test() -> evaluate_clip -> serve --once

def overrides(tree, run_dir, text_path):
    base, annotated, lists, features = tree
    return [
        "networks=clip_convnext_biogpt", "tokenizer=biogpt", TINY_TEXT,
        f"networks.text_encoder.weights_path={text_path}",
        f"dataset.config.base_dataset_path={base}",
        f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}",
        f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        "tokenizer.config.sequence_length=32", "scheduler.config.epochs=3",
        "dataloader.train.batch_size=4", "dataloader.valid.batch_size=2",
        "dataloader.valid.shuffle=false", "dataloader.test.batch_size=2",
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mmgclip_tpu.data.tokenizer import Tokenizer as JaxTokenizer
    from mmgclip_tpu.models.clip import MMGCLIP as JaxMMGCLIP

    root = tmp_path_factory.mktemp("biogpt_slice")
    tree = build_image_label_tree(str(root / "data"), n_benign=10, n_malignant=10, separable=True)
    text_path = str(root / "text_tower.msgpack")
    jax_dir, port_dir = root / "jax_run", root / "port_run"
    jcfg = jax_compose(CONFIGS, "train_binary_class_clf", overrides(tree, jax_dir, text_path),
                       run_dir=str(jax_dir))
    tokenizer = JaxTokenizer.from_pretrained(jcfg.tokenizer.config.tokenizer_name, sequence_length=32)
    model = JaxMMGCLIP(jcfg, seed=int(jcfg.base.seed), vocab_size=tokenizer.vocab_size)
    with open(text_path, "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(model.text_variables)))
    jax_save_snapshot(jcfg, str(jax_dir))
    jax_train.run(jcfg)
    cfg = compose(CONFIGS, "train_binary_class_clf", overrides(tree, port_dir, text_path),
                  run_dir=str(port_dir))
    save_snapshot(cfg, str(port_dir))
    experiment = port_train.run(cfg, device="cpu", init_params=jax.device_get(model.trainable_params))
    return {"jax": jcfg, "port": cfg, "experiment": experiment}


def test_slice_tokens_losses_and_results_equal_jax(runs):
    assert isinstance(runs["experiment"].model.text_module, CausalTextEncoder)
    ours = get_dataset(runs["port"].dataset.name)(config=runs["port"])._tokens
    theirs = jax_get_dataset(runs["jax"].dataset.name)(config=runs["jax"])._tokens
    assert set(ours) == set(theirs)
    for key in theirs:
        assert np.array_equal(ours[key], theirs[key]), key
    want = read_scalars(runs["jax"].base.tensorboard_export_dir)
    got = read_scalars(runs["port"].base.tensorboard_export_dir)
    for tag in ("loss/train", "loss/val"):
        assert len(got[tag]) == 3
        # within 1e-5: the validation loss falls to ~0.07, where fp32 sums in
        # another order part the two packages by ~1e-6
        np.testing.assert_allclose(got[tag], want[tag], rtol=TOL, atol=TOL, err_msg=tag)
    results = [json.load(open(os.path.join(cfg.base.results_export_dir, "results.json")))
               for cfg in (runs["port"], runs["jax"])]
    assert results[0] == results[1] and results[0]["BenignMalignantDatasetLabels"]


def test_slice_evaluate_clip_and_serve_match_jax(runs, capsys):
    port_dir, jax_dir = runs["port"].base.export_dir, runs["jax"].base.export_dir
    evaluate(str(port_dir), "replay", device="cpu")
    replay = json.load(open(os.path.join(port_dir, "replay", "results.json")))
    assert replay == json.load(open(os.path.join(jax_dir, "results", "results.json")))

    feats = np.random.default_rng(7).standard_normal((3, 768)).astype("<f4")
    prompts = ["Finding suggesting benign.", "Finding suggesting malignant."]
    request = {"op": "classify", "features_b64": base64.b64encode(feats.tobytes()).decode(),
               "features_rows": 3, "class_list": prompts, "id": 4}
    capsys.readouterr()
    serve.main(["--experiment_path", str(port_dir), "--device", "cpu", "--once", json.dumps(request)])
    response = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert response["id"] == 4 and "error" not in response, response
    engine = JaxEngine.from_experiment(str(jax_dir))
    want = engine.classify(feats, prompts)
    np.testing.assert_allclose(response["result"]["classes_similarities"],
                               np.asarray(want["classes_similarities"]), atol=TOL, rtol=0)
    assert response["result"]["similarities_argmax"] == list(np.asarray(want["similarities_argmax"]))

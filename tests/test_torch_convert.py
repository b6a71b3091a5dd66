"""The port's weight converters and importers against the JAX package.

* ``models.convnext.torchvision_tree`` and ``models.bert.hf_tree`` give the
  trees of JAX's ``load_torchvision_weights`` / ``load_hf_weights`` leaf by
  leaf (ConvNeXt at the micro size, with and without ``classifier.*``);
* ``utils.safetensors_lite.load_file`` reads what ``safetensors.torch``
  reads, and the hand-written writer of ``tools/fixtures.py`` writes what it
  reads;
* ``tools.convert_convnext`` at full Tiny width (the script hard-codes it):
  one JAX run of ``tools/convert_convnext.py`` on a TorchScript
  classifier; the port's file is byte-equal from the TorchScript archive,
  from its plain state dict and from a ``{"model_state_dict": ...}``
  checkpoint, the same from torchvision's ``[C, 1, 1]`` layer scale; without
  ``classifier.*`` every leaf outside ``head_*`` equals the JAX file's and
  the file loads in both packages; ``--verify`` on the CPU within 1e-4;
* ``tools.convert_bert`` and ``tools.convert_biogpt`` byte-equal to the JAX
  scripts from ``pytorch_model.bin`` and from ``model.safetensors``
  (seeded state dicts under the HF names, prefixed with the heads the
  converters skip, and bare).

The JAX scripts run in this process through ``runpy``.
"""

import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from mmgclip_tpu.models.bert import BertConfig as JaxBertConfig
from mmgclip_tpu.models.bert import init_bert, load_hf_weights
from mmgclip_tpu.models.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from mmgclip_tpu.models.convnext import init_convnext, load_torchvision_weights
from mmgclip_tpu_torch.models.bert import BertConfig, hf_tree
from mmgclip_tpu_torch.models.convnext import ConvNeXtConfig, torchvision_tree
from mmgclip_tpu_torch.tools import convert_bert, convert_biogpt, convert_convnext
from mmgclip_tpu_torch.tools.fixtures import (
    TorchvisionConvNeXt,
    bert_state_dict,
    write_hf_snapshot,
    write_safetensors,
    write_torchscript,
)
from mmgclip_tpu_torch.utils.flax_msgpack import read_file
from mmgclip_tpu_torch.utils.safetensors_lite import load_file
from mmgclip_tpu_torch.weights import flatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_tool(name, *argv):
    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(REPO, "tools", name), run_name="__main__")
    finally:
        sys.argv = saved


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def assert_trees_equal(ours, theirs):
    ours, theirs = flatten_tree(ours), flatten_tree(theirs)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def micro_state_dict(classifier=True):
    sd = TorchvisionConvNeXt(in_channels=1, dims=(8, 16, 32, 768), depths=(1, 1, 2, 1),
                             flat_layer_scale=True, seed=3).state_dict()
    return {k: v for k, v in sd.items() if classifier or not k.startswith("classifier.")}


@pytest.mark.parametrize("classifier", [True, False])
def test_torchvision_tree_matches_load_torchvision_weights(classifier):
    sd = micro_state_dict(classifier)
    jax_config = JaxConvNeXtConfig(depths=(1, 1, 2, 1), dims=(8, 16, 32, 768), in_channels=1)
    _module, params = init_convnext(jax_config, image_size=32)
    theirs = jax.device_get(load_torchvision_weights(params, sd, jax_config))
    ours = torchvision_tree(sd, ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(8, 16, 32, 768),
                                               in_channels=1))
    if not classifier:  # JAX keeps flax's init there; the port's tree has no head
        theirs["params"] = {k: v for k, v in theirs["params"].items() if not k.startswith("head_")}
    assert_trees_equal(ours, theirs)


def test_torchvision_layer_scale_layouts_give_one_tree():
    flat = micro_state_dict()
    nested = {k: v.reshape(-1, 1, 1) if k.endswith("layer_scale") else v for k, v in flat.items()}
    config = ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(8, 16, 32, 768), in_channels=1)
    assert_trees_equal(torchvision_tree(nested, config), torchvision_tree(flat, config))


BERT_CONFIG = {"vocab_size": 96, "hidden_size": 32, "num_hidden_layers": 2,
               "num_attention_heads": 4, "intermediate_size": 64,
               "max_position_embeddings": 40, "type_vocab_size": 2}


def tiny_bert(prefixed):
    """A seeded HF BERT state dict: ``BertForPreTraining``'s names
    (``bert.``-prefixed, with the pooler and the ``cls.`` heads the
    converters skip) or ``BertModel``'s."""
    sd = bert_state_dict(BERT_CONFIG, seed=1)
    g = torch.Generator().manual_seed(5)
    h = BERT_CONFIG["hidden_size"]
    sd["bert.pooler.dense.weight"] = torch.randn(h, h, generator=g)
    sd["bert.pooler.dense.bias"] = torch.randn(h, generator=g)
    if prefixed:
        sd["cls.predictions.bias"] = torch.randn(BERT_CONFIG["vocab_size"], generator=g)
        sd["cls.seq_relationship.weight"] = torch.randn(2, h, generator=g)
        return dict(BERT_CONFIG), sd
    return dict(BERT_CONFIG), {k[len("bert."):]: v for k, v in sd.items()}


def tiny_biogpt(prefixed):
    """A seeded HF BioGPT config and state dict (``BioGptForCausalLM``'s
    ``biogpt.`` names with its output projection, or ``BioGptModel``'s)."""
    config = {"vocab_size": 80, "hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 64,
              "max_position_embeddings": 48, "scale_embedding": True}
    g = torch.Generator().manual_seed(2)
    h, i = config["hidden_size"], config["intermediate_size"]

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {"embed_tokens.weight": t(config["vocab_size"], h),
          "embed_positions.weight": t(config["max_position_embeddings"] + 2, h),
          "layer_norm.weight": 1 + t(h), "layer_norm.bias": t(h)}
    for layer in range(config["num_hidden_layers"]):
        pre = f"layers.{layer}."
        for name, shape in (("self_attn.q_proj", (h, h)), ("self_attn.k_proj", (h, h)),
                            ("self_attn.v_proj", (h, h)), ("self_attn.out_proj", (h, h)),
                            ("fc1", (i, h)), ("fc2", (h, i))):
            sd[pre + name + ".weight"] = t(*shape)
            sd[pre + name + ".bias"] = t(shape[0])
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[pre + name + ".weight"] = 1 + t(h)
            sd[pre + name + ".bias"] = t(h)
    if prefixed:
        sd = {f"biogpt.{k}": v for k, v in sd.items()}
        sd["output_projection.weight"] = t(config["vocab_size"], h)
    return config, sd


def test_hf_tree_matches_load_hf_weights():
    hf_config, sd = tiny_bert(prefixed=False)
    jax_config = JaxBertConfig(**hf_config)
    _module, params = init_bert(jax_config)
    theirs = jax.device_get(load_hf_weights(params, sd, jax_config))
    assert_trees_equal(hf_tree(sd, BertConfig(**hf_config)), theirs)


def test_safetensors_reader_matches_the_library(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = {"a.weight": torch.randn(3, 4), "b": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "c.half": torch.randn(5).half(), "d.bf16": torch.randn(2, 2).bfloat16(),
               "e.empty": torch.zeros(0, 3)}
    library, ours = str(tmp_path / "lib.safetensors"), str(tmp_path / "ours.safetensors")
    st.save_file(tensors, library)
    write_safetensors(ours, tensors)
    for path in (library, ours):
        want, got = st.load_file(path), load_file(path)
        assert set(got) == set(want) == set(tensors)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
            assert torch.equal(got[key], want[key]), key


@pytest.fixture(scope="module")
def convnext_artifacts(tmp_path_factory):
    """A full-width ConvNeXt-Tiny TorchScript classifier (the JAX script's
    layer-scale layout) and the JAX script's file for it."""
    root = tmp_path_factory.mktemp("convnext")
    module = TorchvisionConvNeXt(in_channels=1, flat_layer_scale=True, seed=0)
    scripted = str(root / "classifier.pt")
    write_torchscript(module, scripted, torch.zeros(1, 1, 64, 64))
    jax_out = str(root / "jax.npz")
    run_jax_tool("convert_convnext.py", "--input", scripted, "--output", jax_out)
    return {"root": root, "scripted": scripted, "jax": jax_out, "state_dict": module.state_dict()}


def test_convert_convnext_torchscript_is_byte_equal_and_verifies(convnext_artifacts, tmp_path):
    out = str(tmp_path / "port.npz")
    result = convert_convnext.main(["--input", convnext_artifacts["scripted"], "--output", out,
                                    "--verify", "--device", "cpu"])
    assert result["max_abs_err"] <= 1e-4
    assert read_bytes(out) == read_bytes(convnext_artifacts["jax"])


@pytest.mark.parametrize("layout", ["state_dict", "model_state_dict", "torchvision_layer_scale"])
def test_convert_convnext_from_checkpoints_is_byte_equal(convnext_artifacts, tmp_path, layout, capsys):
    sd = dict(convnext_artifacts["state_dict"])
    if layout == "torchvision_layer_scale":
        sd = {k: v.reshape(-1, 1, 1) if k.endswith("layer_scale") else v for k, v in sd.items()}
    path = str(tmp_path / "ckpt.pt")
    torch.save({"model_state_dict": sd} if layout == "model_state_dict" else sd, path)
    out = str(tmp_path / "port.npz")
    result = convert_convnext.main(["--input", path, "--output", out, "--verify", "--device", "cpu"])
    assert result["max_abs_err"] is None
    assert "WARNING: --verify needs a TorchScript input" in capsys.readouterr().out
    assert read_bytes(out) == read_bytes(convnext_artifacts["jax"])


def test_convert_convnext_without_classifier_keeps_every_other_leaf(convnext_artifacts, tmp_path):
    sd = {k: v for k, v in convnext_artifacts["state_dict"].items() if not k.startswith("classifier.")}
    path = str(tmp_path / "features_only.pt")
    torch.save(sd, path)
    out = str(tmp_path / "port.npz")
    convert_convnext.main(["--input", path, "--output", out, "--device", "cpu"])
    ours = flatten_tree(read_file(out))
    theirs = flatten_tree(read_file(convnext_artifacts["jax"]))
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        if not key.startswith("params.head_"):
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
    # flax reads the file to the JAX file's tree, and the port loads it
    restored = serialization.msgpack_restore(read_bytes(out))
    want = serialization.msgpack_restore(read_bytes(convnext_artifacts["jax"]))
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(want)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(want)))
    convert_convnext.load_tower(sd, "cpu")


@pytest.mark.parametrize("kind,prefixed", [("bin", True), ("safetensors", False)])
def test_convert_bert_is_byte_equal(tmp_path, kind, prefixed):
    hf_config, sd = tiny_bert(prefixed)
    snapshot = write_hf_snapshot(str(tmp_path / "snap"), hf_config, sd, kind)
    jax_out, port_out = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    run_jax_tool("convert_bert.py", "--input", snapshot, "--output", jax_out)
    convert_bert.main(["--input", snapshot, "--output", port_out, "--device", "cpu"])
    assert read_bytes(port_out) == read_bytes(jax_out)


@pytest.mark.parametrize("kind,prefixed", [("bin", False), ("safetensors", True)])
def test_convert_biogpt_is_byte_equal(tmp_path, kind, prefixed):
    hf_config, sd = tiny_biogpt(prefixed)
    snapshot = write_hf_snapshot(str(tmp_path / "snap"), hf_config, sd, kind)
    jax_out, port_out = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    run_jax_tool("convert_biogpt.py", "--input", snapshot, "--output", jax_out)
    convert_biogpt.main(["--input", snapshot, "--output", port_out, "--device", "cpu"])
    assert read_bytes(port_out) == read_bytes(jax_out)


@pytest.mark.parametrize("tool", [convert_convnext, convert_bert, convert_biogpt])
def test_converters_raise_without_a_card_unless_the_cpu_is_asked(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--input", "/nonexistent", "--output", "/nonexistent.out"])

"""The port's towers and heads against the JAX package's, on carried-across
parameters.

JAX-initialised micro ConvNeXt, tiny BERT and the projection heads are moved
into the port with ``mmgclip_tpu_torch.weights`` and run on the same numpy
inputs.  Tolerances: features within 1e-4 relative (fp32, different
summation order); pooling, pad-trimming and zero rows exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.models.bert import BertConfig as JaxBertConfig
from mmgclip_tpu.models.bert import eos_pool as jax_eos_pool
from mmgclip_tpu.models.bert import init_bert
from mmgclip_tpu.models.bert import trim_padded_tail as jax_trim
from mmgclip_tpu.models.clip import l2_normalize as jax_l2
from mmgclip_tpu.models.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from mmgclip_tpu.models.convnext import init_convnext
from mmgclip_tpu.models.projections import (
    LinearProjectionLayer as JaxLinear,
    MLPProjectionHead as JaxMLP,
    MultiLinearHead as JaxMultiLinear,
)
from mmgclip_tpu_torch.models.bert import BertConfig, BertEncoder, eos_pool, trim_padded_tail
from mmgclip_tpu_torch.models.clip import l2_normalize
from mmgclip_tpu_torch.models.convnext import ConvNeXt, ConvNeXtConfig
from mmgclip_tpu_torch.models.projections import (
    LinearProjectionLayer,
    MLPProjectionHead,
    MultiLinearHead,
)
from mmgclip_tpu_torch.weights import flatten_tree, load_flax_tree

FEATURE_RTOL = 1e-4


def assert_close_rel(out, ref, rtol=FEATURE_RTOL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rtol * max(np.abs(ref).max(), 1e-6)


def host_tree(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


@pytest.fixture(scope="module")
def micro_convnext():
    cfg = dataclasses.replace(JaxConvNeXtConfig.micro(), layer_scale_init=0.5)
    module, params = init_convnext(cfg, seed=3, image_size=32)
    return cfg, module, host_tree(params)


@pytest.mark.parametrize("hw", [(37, 29), (32, 32)])
@pytest.mark.parametrize("fused", [False, True])
def test_convnext_features_match_jax(micro_convnext, hw, fused):
    jcfg, jmodule, params = micro_convnext
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jmodule.apply(params, jnp.asarray(x)))
    port = ConvNeXt(ConvNeXtConfig(depths=jcfg.depths, dims=jcfg.dims,
                                   use_fused_blocks=fused)).eval()
    load_flax_tree(port, params["params"])
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert_close_rel(out, ref)


def test_convnext_classify_head_matches_jax(micro_convnext):
    jcfg, jmodule, params = micro_convnext
    x = np.random.default_rng(1).standard_normal((2, 33, 35, 3)).astype(np.float32)
    ref = np.asarray(jmodule.apply(params, jnp.asarray(x), classify=True))
    port = ConvNeXt(ConvNeXtConfig(depths=jcfg.depths, dims=jcfg.dims)).eval()
    load_flax_tree(port, params["params"])
    with torch.no_grad():
        assert_close_rel(port(torch.from_numpy(x), classify=True).numpy(), ref)


def test_convnext_bf16_tower_tracks_jax():
    jcfg = dataclasses.replace(JaxConvNeXtConfig.micro(), layer_scale_init=0.5,
                               dtype=jnp.bfloat16, use_fused_blocks=True)
    jmodule, params = init_convnext(jcfg, seed=4, image_size=32)
    params = host_tree(params)
    x = np.random.default_rng(2).standard_normal((2, 40, 36, 3)).astype(np.float32)
    ref = np.asarray(jmodule.apply(params, jnp.asarray(x)), np.float32)
    port = ConvNeXt(ConvNeXtConfig(depths=jcfg.depths, dims=jcfg.dims, dtype=torch.bfloat16,
                                   use_fused_blocks=True)).eval()
    load_flax_tree(port, params["params"])
    with torch.no_grad():
        out = port(torch.from_numpy(x)).float().numpy()
    cosine = (out * ref).sum(1) / (np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
    assert (cosine > 0.999).all(), cosine


def test_tree_mismatch_raises(micro_convnext):
    _cfg, _module, params = micro_convnext
    port = ConvNeXt(ConvNeXtConfig.tiny())
    with pytest.raises(ValueError):  # same keys, other widths
        load_flax_tree(port, params["params"])
    broken = {"params": dict(params["params"])}
    broken["params"].pop("head_fc")
    with pytest.raises(KeyError):
        load_flax_tree(ConvNeXt(ConvNeXtConfig.micro()), broken["params"])


@pytest.fixture(scope="module")
def tiny_bert():
    cfg = JaxBertConfig.tiny()
    module, params = init_bert(cfg, seed=5)
    return cfg, module, host_tree(params)


def bert_inputs(seed=0, b=4, s=24, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    lens = np.array([s, 17, 1, 9][:b])
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("use_flash", [False, True])
def test_bert_hidden_states_match_jax(tiny_bert, use_flash):
    jcfg, jmodule, params = tiny_bert
    ids, mask = bert_inputs()
    ref = np.asarray(jmodule.apply(params, jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    port = BertEncoder(BertConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                                     if f.name not in ("dtype", "use_flash_attention")},
                                  use_flash_attention=use_flash)).eval()
    load_flax_tree(port, params["params"])
    with torch.no_grad():
        out = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert_close_rel(out, ref)


def test_bert_layout_is_the_jax_layout(tiny_bert):
    jcfg, _module, params = tiny_bert
    port = BertEncoder(BertConfig.tiny())
    flat = flatten_tree(params["params"])
    state = port.state_dict()
    assert set(flat) == set(state)
    for key, value in flat.items():
        assert tuple(state[key].shape) == value.shape, key
    heads = jcfg.num_attention_heads
    assert tuple(state["qkv_kernel"].shape) == (2, 64, 3, heads, 64 // heads)


def test_eos_pool_is_exact():
    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((4, 10, 8)).astype(np.float32)
    mask = (np.arange(10)[None, :] < np.array([10, 3, 0, 1])[:, None]).astype(np.int32)
    ref = np.asarray(jax_eos_pool(jnp.asarray(hidden), jnp.asarray(mask)))
    out = eos_pool(torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("longest", [3, 31, 32, 33, 64])
def test_trim_padded_tail_is_exact(longest):
    s = 64
    ids = np.arange(3 * s, dtype=np.int32).reshape(3, s)
    mask = (np.arange(s)[None, :] < np.array([longest, 2, 1])[:, None]).astype(np.int32)
    tokens = {"input_ids": ids, "attention_mask": mask, "token_type_ids": np.zeros_like(ids)}
    ref = jax_trim(dict(tokens), 32)
    out = trim_padded_tail(dict(tokens), 32)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(out[key]), np.asarray(ref[key]))
    as_tensors = trim_padded_tail({k: torch.from_numpy(v) for k, v in tokens.items()}, 32)
    for key in ref:
        np.testing.assert_array_equal(as_tensors[key].numpy(), np.asarray(ref[key]))


def test_trimmed_tower_equals_untrimmed_on_valid_rows(tiny_bert):
    _cfg, _module, params = tiny_bert
    port = BertEncoder(BertConfig.tiny()).eval()
    load_flax_tree(port, params["params"])
    ids, mask = bert_inputs(seed=7, s=64)
    mask[0, 30:] = 0
    tokens = {"input_ids": ids, "attention_mask": mask}
    trimmed = trim_padded_tail(tokens, 32)
    assert trimmed["input_ids"].shape[1] == 32
    with torch.no_grad():
        full = eos_pool(port(torch.from_numpy(ids), torch.from_numpy(mask)), torch.from_numpy(mask))
        short = eos_pool(port(torch.from_numpy(trimmed["input_ids"]),
                              torch.from_numpy(trimmed["attention_mask"])),
                         torch.from_numpy(trimmed["attention_mask"]))
    torch.testing.assert_close(short, full, rtol=1e-5, atol=1e-5)


HEADS = [
    (JaxLinear, LinearProjectionLayer, {"projection_dim": 16}),
    (JaxMultiLinear, MultiLinearHead, {"projection_dim": (24, 16)}),
    (JaxMultiLinear, MultiLinearHead, {"projection_dim": (24, 20, 16)}),
    (JaxMLP, MLPProjectionHead, {"projection_dim": 16}),
]


@pytest.mark.parametrize("jax_cls,port_cls,kwargs", HEADS)
def test_projection_heads_match_jax(jax_cls, port_cls, kwargs):
    x = np.random.default_rng(8).standard_normal((5, 12)).astype(np.float32)
    jhead = jax_cls(embedding_dim=12, dropout=0.5, **kwargs)
    variables = jhead.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(jhead.apply(variables, jnp.asarray(x), deterministic=True))
    head = port_cls(12, kwargs["projection_dim"], 0.5).eval()
    load_flax_tree(head, host_tree(variables["params"]))
    with torch.no_grad():
        out = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_l2_normalize_matches_jax_including_a_zero_row():
    x = np.random.default_rng(9).standard_normal((4, 7)).astype(np.float32)
    x[2] = 0.0
    ref = np.asarray(jax_l2(jnp.asarray(x)))
    out = l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    assert np.array_equal(out[2], np.zeros(7, np.float32))
    leaf = torch.from_numpy(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(l2_normalize(leaf).sum(), leaf)
    assert torch.isfinite(grad).all()  # finite at the zero row too

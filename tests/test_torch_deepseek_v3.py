"""The DeepSeek-V3 text tower (``models/deepseek_v3.py``), the plain paths of
its routed experts (``ops/moe_experts.py``), of its attention
(``ops/mla_attention.py``) and of its norms (``ops/rms_norm.py``), the last
two bit-equal to the arithmetic the layer ran inline, and the trainer's bank
over it,
held against the plain reference ``tests/reference_deepseek_v3.py`` at a
tiny size on the CPU (hidden 64, 1 dense + 2 MoE layers, 8 experts, top-2,
1 shared expert, latent 16, rope 8).  Weights are drawn at 1 / sqrt(fan in)
so that every layer moves the residual stream; float32 towers match to
1e-4 of the largest value; bfloat16 ones (activations rounded between the
products) within 1.5e-2 relative by the median token and 3e-2 for nine
tokens in ten (a token whose selection sits at a near tie may flip)."""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import reference_deepseek_v3 as ref
from mmgclip_tpu_torch.models.deepseek_v3 import (
    DeepseekV3Config,
    DeepseekV3TextEncoder,
    MoE,
    _Params,
    attention_masks,
    hf_names,
    load_deepseek_v3_weights,
    parameter_count,
    read_snapshot,
    rope_tables,
)
from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.ops.flash_attention import NEG_INF
from mmgclip_tpu_torch.ops.mla_attention import mla_attention, plain_mla_attention, rope_pairs
from mmgclip_tpu_torch.ops.moe_experts import dispatch, plain_moe_experts
from mmgclip_tpu_torch.ops.rms_norm import plain_rms_norm, rms_norm
from torch_deepseek_v3 import TINY, hf_state_dict

FP32 = dataclasses.replace(TINY, dtype=torch.float32)


def cfg_dict(c: DeepseekV3Config) -> dict:
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c) if f.name != "dtype"}


def hf_weights(c: DeepseekV3Config, seed: int = 0, bias_std: float = 0.1) -> dict:
    """HF-named weights at 1 / sqrt(fan in), norms 1 +- 0.1, the selection
    bias at ``bias_std``, rounded to the tower's dtype."""
    g = torch.Generator().manual_seed(seed)
    donor = DeepseekV3TextEncoder(c, device="meta")
    out = {}
    for name in hf_names(c):
        shape = _shape(donor, name)
        if name.endswith("e_score_correction_bias"):
            out["model." + name] = torch.randn(shape, generator=g) * bias_std
            continue
        if name.endswith("norm.weight"):
            t = 1 + 0.1 * torch.randn(shape, generator=g)
        else:
            t = torch.randn(shape, generator=g) / (1.0 if "embed" in name else shape[-1] ** 0.5)
        out["model." + name] = t.to(c.dtype)
    return out


def _shape(module, hf_name):
    sd = hf_state_dict(module)
    return tuple(sd["model." + hf_name].shape)


def tower(c: DeepseekV3Config, seed: int = 0):
    """-> (the port's tower loaded from ``hf_weights``, the weights in float32)."""
    weights = hf_weights(c, seed)
    reference = {k: v.float() for k, v in weights.items()}
    module = DeepseekV3TextEncoder(c, device="meta")
    load_deepseek_v3_weights(module, dict(weights))
    return module, reference


def ragged(b=4, s=12, lengths=(12, 7, 3, 1), seed=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, TINY.vocab_size, (b, s), generator=g)
    mask = (torch.arange(s)[None] < torch.tensor(lengths)[:, None]).to(torch.int32)
    return ids * mask, mask


# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_reference_under_ragged_padding(dtype):
    c = dataclasses.replace(TINY, dtype=dtype)
    module, weights = tower(c)
    ids, mask = ragged()
    with torch.no_grad():
        got = module(ids, attention_mask=mask)
    want = ref.forward(weights, cfg_dict(c), ids, mask)
    valid = mask > 0
    assert got.dtype == torch.float32
    if dtype == torch.float32:
        assert float((got - want)[valid].abs().max() / want[valid].abs().max()) < 1e-4
        # a row alone, unpadded, gives what it gave inside the padded batch
        alone = module(ids[1:2, :7], attention_mask=mask[1:2, :7])
        torch.testing.assert_close(alone[0], got[1, :7], rtol=1e-5, atol=1e-5)
    else:  # a token whose selection sits at a near tie may flip under the rounding
        errors = (got - want)[valid].norm(dim=1) / want[valid].norm(dim=1)
        assert float(errors.median()) < 1.5e-2 and float((errors > 3e-2).float().mean()) <= 0.1


@pytest.mark.parametrize("case", ["bias_selects_only", "normalized_and_scaled", "empty_expert"])
def test_routing(case):
    c = FP32
    build = _Params(c, torch.device("cpu"), torch.Generator().manual_seed(1))
    moe = MoE(c, build)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        moe.gate.copy_(torch.randn(moe.gate.shape, generator=g))
        moe.e_score_correction_bias.copy_(0.3 * torch.randn(c.n_routed_experts, generator=g))
        if case == "empty_expert":
            moe.e_score_correction_bias[5] = -100.0
    x = torch.randn(40, c.hidden_size, generator=g)
    chosen, weights = moe.route(x)
    scores = torch.sigmoid(x @ moe.gate.T)
    if case == "bias_selects_only":
        want = torch.topk(scores + moe.e_score_correction_bias, c.num_experts_per_tok).indices
        assert torch.equal(chosen.sort(1).values, want.sort(1).values)
        # without the bias at least one token would choose otherwise
        plain = torch.topk(scores, c.num_experts_per_tok).indices
        assert not torch.equal(chosen.sort(1).values, plain.sort(1).values)
    elif case == "normalized_and_scaled":
        picked = scores.gather(1, chosen)
        torch.testing.assert_close(weights, picked / picked.sum(1, keepdim=True)
                                   * c.routed_scaling_factor)
        torch.testing.assert_close(weights.sum(1), torch.full((40,), c.routed_scaling_factor))
    else:
        assert not (chosen == 5).any()
        plan = dispatch(chosen, c.n_routed_experts)
        assert int(plan.counts[5]) == 0 and int(plan.counts.sum()) == 40 * c.num_experts_per_tok
        I = c.moe_intermediate_size
        sd = {"gate.weight": moe.gate, "gate.e_score_correction_bias": moe.e_score_correction_bias,
              **{f"shared_experts.{n}.weight": getattr(moe.shared_experts, n)
                 for n in ("gate_proj", "up_proj", "down_proj")}}
        for j in range(c.n_routed_experts):
            sd[f"experts.{j}.gate_proj.weight"] = moe.w_gate_up[j, :I]
            sd[f"experts.{j}.up_proj.weight"] = moe.w_gate_up[j, I:]
            sd[f"experts.{j}.down_proj.weight"] = moe.w_down[j]
        want = ref.moe(x[None], sd, "", cfg_dict(c))[0]
        with torch.no_grad():
            got = moe(x[None])[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq", [1, 5, 17])
def test_rope_pairs_match_deinterleaved_rotate_half(seq):
    g = torch.Generator().manual_seed(seq)
    d, theta = TINY.qk_rope_head_dim, TINY.rope_theta
    q, k = torch.randn(2, seq, 3, d, generator=g), torch.randn(2, seq, 3, d, generator=g)
    cos, sin = rope_tables(seq, d, theta, "cpu")
    ours = rope_pairs(q, cos, sin).transpose(1, 2) @ rope_pairs(k, cos, sin).permute(0, 2, 3, 1)
    pos = torch.arange(seq)
    hf_q = ref.apply_rope(q.transpose(1, 2), pos, d, theta)
    hf_k = ref.apply_rope(k.transpose(1, 2), pos, d, theta)
    torch.testing.assert_close(ours, hf_q @ hf_k.transpose(-1, -2), rtol=1e-5, atol=1e-5)
    # pair i of position p turns by p * theta^(-2i / d)
    unit = torch.zeros(1, seq, 1, d)
    unit[..., 2] = 1.0
    turned = rope_pairs(unit, cos, sin)[0, :, 0]
    angle = pos.double() * theta ** (-2.0 / d)
    torch.testing.assert_close(turned[:, 2].double(), angle.cos(), rtol=0, atol=1e-6)
    torch.testing.assert_close(turned[:, 3].double(), angle.sin(), rtol=0, atol=1e-6)


def _inline_attention(q, k_pe, kv, cos, sin, mask, H, nope, rope, vd):
    """The tower's attention as ``Attention.forward`` wrote it inline before
    it moved to ``ops/mla_attention.py`` (``rope_pairs`` written out too)."""
    def rope_then(x):
        xf = x.float().unflatten(-1, (-1, 2))
        c, s = cos[None, :, None], sin[None, :, None]
        a, b = xf[..., 0], xf[..., 1]
        return torch.stack((a * c - b * s, a * s + b * c), dim=-1).flatten(-2).to(x.dtype)

    b, s, _ = q.shape
    q = q.view(b, s, H, nope + rope)
    kv = kv.view(b, s, H, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = rope_then(q[..., nope:])
    k_pe = rope_then(k_pe[:, :, None]).expand(b, s, H, rope)
    query = torch.cat([q[..., :nope], q_pe], dim=-1).transpose(1, 2).float()
    key = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2).float()
    scores = torch.matmul(query, key.transpose(-1, -2)) * (1.0 / math.sqrt(nope + rope))
    scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, H * vd)


MASKS = {  # [rows, 12] key masks
    "prefix": [[1] * n + [0] * (12 - n) for n in (12, 7, 3, 1)],
    "hole": [[1, 1, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0], [1] * 12],
    "left_padded": [[0] * 5 + [1] * 7, [1] * 9 + [0] * 3],
    "all_zero": [[0] * 12, [1] * 4 + [0] * 8],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masks", sorted(MASKS))
def test_plain_mla_attention_is_the_inline_arithmetic(masks, dtype):
    """``plain_mla_attention`` bit-equal to the arithmetic the layer ran
    inline, under prefix masks, a mask with holes, a left-padded row and a
    row without a valid key; ``mla_attention`` takes it for CPU tensors and
    launches nothing."""
    c = TINY
    H, nope, rope, vd = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    keys = torch.tensor(MASKS[masks], dtype=torch.int32)
    b, s = keys.shape
    g = torch.Generator().manual_seed(len(masks))
    q = torch.randn(b, s, H * (nope + rope), generator=g).to(dtype)
    k_pe = torch.randn(b, s, c.kv_lora_rank + rope, generator=g).to(dtype)[..., c.kv_lora_rank:]
    kv = torch.randn(b, s, H * (nope + vd), generator=g).to(dtype)
    cos, sin = rope_tables(s, rope, c.rope_theta, "cpu")
    want = _inline_attention(q, k_pe, kv, cos, sin, attention_masks(keys), H, nope, rope, vd)
    assert torch.equal(plain_mla_attention(q, k_pe, kv, cos, sin, keys, H), want)
    before = launch_counts()["mla_attention"]
    assert torch.equal(mla_attention(q, k_pe, kv, cos, sin, keys, H), want)
    assert launch_counts()["mla_attention"] == before
    assert torch.isfinite(want).all()


def _inline_rms_norm(x, weight, eps, dtype=None):
    """The tower's RMSNorm as it ran inline before ``ops/rms_norm.py``."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * weight.float()
    return out.to(x.dtype if dtype is None else dtype)


NORM_CASES = {  # name -> (dtype of the rows, their width, row stride, output dtype)
    "hidden_bf16": (torch.bfloat16, 64, 64, None),
    "hidden_fp32": (torch.float32, 64, 64, None),
    "c_kv_view": (torch.bfloat16, 16, 24, None),  # the split kv_a output, latent 16 + rope 8
    "final_to_fp32": (torch.bfloat16, 64, 64, torch.float32),
}


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_plain_rms_norm_is_the_inline_arithmetic(case):
    """``plain_rms_norm`` bit-equal to the arithmetic the tower ran inline: a
    hidden row in bf16 and in float32, the strided ``c_kv`` view of the
    ``kv_a`` output, the final norm into float32; ``rms_norm`` takes it for
    CPU tensors and launches nothing."""
    dtype, width, stride, out = NORM_CASES[case]
    g = torch.Generator().manual_seed(width + stride)
    x = (3 * torch.randn(3, 7, stride, generator=g)).to(dtype)[..., :width]
    weight = (1 + 0.1 * torch.randn(width, generator=g)).to(dtype)
    want = _inline_rms_norm(x, weight, 1e-5, out)
    assert want.dtype == (dtype if out is None else out)
    assert torch.equal(plain_rms_norm(x, weight, 1e-5, out), want)
    before = launch_counts()["rms_norm"]
    assert torch.equal(rms_norm(x, weight, 1e-5, out), want)
    assert launch_counts()["rms_norm"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_tower_is_unchanged_by_its_norm_op(dtype, monkeypatch):
    """The tower's CPU output bit-equal to its output with every RMSNorm
    computed inline, as before ``ops/rms_norm.py``."""
    from mmgclip_tpu_torch.models import deepseek_v3

    module, _weights = tower(dataclasses.replace(TINY, dtype=dtype))
    ids, mask = ragged()
    with torch.no_grad():
        got = module(ids, attention_mask=mask)
        monkeypatch.setattr(deepseek_v3.RMSNorm, "forward",
                            lambda self, x, dtype=None: _inline_rms_norm(x, self.weight,
                                                                         self.eps, dtype))
        want = module(ids, attention_mask=mask)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tokens,k,experts,dtype", [(50, 2, 8, torch.bfloat16),
                                                     (33, 6, 16, torch.bfloat16),
                                                     (20, 3, 8, torch.float32)])
def test_plain_experts_match_a_per_token_loop(tokens, k, experts, dtype):
    g = torch.Generator().manual_seed(tokens)
    D, I = 24, 16
    x = torch.randn(tokens, D, generator=g).to(dtype)
    w13 = (torch.randn(experts, 2 * I, D, generator=g) / D ** 0.5).to(dtype)
    w2 = (torch.randn(experts, D, I, generator=g) / I ** 0.5).to(dtype)
    pool = torch.tensor([e for e in range(experts) if e != 1])  # expert 1 gets no token
    chosen = torch.stack([pool[torch.randperm(len(pool), generator=g)[:k]] for _ in range(tokens)])
    weights = torch.rand(tokens, k, generator=g)
    got = plain_moe_experts(x, dispatch(chosen, experts), weights, w13, w2)
    want = torch.zeros(tokens, D)
    for t in range(tokens):
        for s in range(k):
            e = chosen[t, s]
            gate_up = x[t].float() @ w13[e].float().T
            h = (torch.nn.functional.silu(gate_up[:I]) * gate_up[I:]).to(dtype).float()
            want[t] += ((h @ w2[e].float().T) * weights[t, s]).to(dtype).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7  # one bf16 step of a rounded row
    torch.testing.assert_close(got, want, rtol=tol, atol=1e-5)


@pytest.mark.parametrize("source", ["state_dict", "snapshot"])
def test_hf_loader_round_trip(source, tmp_path):
    weights = hf_weights(TINY, seed=4)
    module = DeepseekV3TextEncoder(TINY, device="meta")
    if source == "state_dict":
        given = dict(weights, **{"lm_head.weight": torch.zeros(3)})
        read = load_deepseek_v3_weights(module, given)
        assert sorted(read) == sorted(hf_names(TINY)) and list(given) == ["lm_head.weight"]
    else:
        from mmgclip_tpu_torch.tools.fixtures import write_safetensors

        names = sorted(weights)
        write_safetensors(str(tmp_path / "model-00001-of-00002.safetensors"),
                          {n: weights[n] for n in names[::2]})
        write_safetensors(str(tmp_path / "model-00002-of-00002.safetensors"),
                          {n: weights[n] for n in names[1::2]})
        read_snapshot(module, str(tmp_path), "cpu")
    assert not any(p.is_meta for p in module.parameters())
    back = hf_state_dict(module)
    assert sorted(back) == sorted(weights)
    for name, value in weights.items():
        assert torch.equal(back[name], value), name
    incomplete = dict(weights)
    incomplete.pop("model.layers.2.mlp.experts.3.up_proj.weight")
    with pytest.raises(KeyError, match="missing"):
        load_deepseek_v3_weights(DeepseekV3TextEncoder(TINY, device="meta"), incomplete)


class _Rows:
    def __init__(self, features, tokens):
        self._features, self._tokens = features, tokens

    def __len__(self):
        return len(self._features)


def _trainer(tmp_path, weights, rows, seed=0):
    from mmgclip_tpu_torch.cli import DEFAULT_CONFIG_DIR
    from mmgclip_tpu_torch.config import compose
    from mmgclip_tpu_torch.data.loader import DataLoader
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment

    sizes = ", ".join(f"{k}: {v}" for k, v in cfg_dict(FP32).items())
    cfg = compose(DEFAULT_CONFIG_DIR, "train_binary_class_clf",
                  ["networks=clip_convnext_moonlight_text", "projection=2xLinear512",
                   "networks.text_encoder.config={" + sizes.replace("True", "true")
                   + ", dtype: float32}", "dataloader.train.batch_size=4", "base.seed=0"],
                  run_dir=str(tmp_path))
    cfg.base.tensorboard_export_dir = str(tmp_path / "tb")
    return ClassifierExperiment(config=cfg, train_dataloader=DataLoader(rows, batch_size=4,
                                                                        drop_last=True),
                                device="cpu", text_weights=weights)


def _bank_rows(seed, n=12, s=40):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 20, n)
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(0, TINY.vocab_size, (n, s)).astype(np.int32) * mask
    return _Rows(rng.normal(size=(n, 768)).astype(np.float32),
                 {"input_ids": ids, "attention_mask": mask})


def _pooled_reference(weights, rows):
    ids = torch.as_tensor(rows._tokens["input_ids"])
    mask = torch.as_tensor(rows._tokens["attention_mask"])
    hidden = ref.forward(weights, cfg_dict(FP32), ids, mask)
    return hidden[torch.arange(len(ids)), mask.sum(1) - 1]


def test_pool_tokens_and_a_second_sweep_match_the_reference(tmp_path):
    weights = hf_weights(FP32, seed=5)
    reference = {k: v.clone() for k, v in weights.items()}
    first, second = _bank_rows(6), _bank_rows(7)
    exp = _trainer(tmp_path, weights, first)
    assert not weights  # the tower took the tensors over
    torch.testing.assert_close(exp._text_bank, _pooled_reference(reference, first),
                               rtol=1e-4, atol=1e-4)
    exp.train()
    bank = exp._text_train_bank
    exp.set_train_data(torch_loader(second))
    want = _pooled_reference(reference, second)
    torch.testing.assert_close(exp._text_bank, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(exp._text_train_bank, want, rtol=1e-4, atol=1e-4)
    assert exp._text_train_bank is not bank  # no captured step on the CPU: rebuilt
    assert np.isfinite(exp.train())


def torch_loader(rows):
    from mmgclip_tpu_torch.data.loader import DataLoader

    return DataLoader(rows, batch_size=4, drop_last=True)


def test_the_bank_records_its_spans_under_a_profiler(tmp_path):
    from mmgclip_tpu_torch.utils import profiling

    rows = _bank_rows(8, n=300)
    exp = _trainer(tmp_path, hf_weights(FP32, seed=9), _bank_rows(6))
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        exp._pool_tokens(rows._tokens)
    records = profiling.spans()
    encode = [r for r in records if r["name"] == "bank.encode"]
    chunks = [r for r in records if r["name"] == "bank.chunk"]
    assert len(encode) == 1 and encode[0]["attrs"] == {"rows": 300, "width": 32}
    assert [c["attrs"]["rows"] for c in chunks] == [256, 44]
    assert all(set(c["attrs"]) == {"rows", "valid_tokens", "computed_tokens"} for c in chunks)
    assert all(c["parent"] == encode[0]["id"] for c in chunks)
    assert encode[0]["parent"] is None
    assert {r["name"] for r in records} == {"bank.encode", "bank.chunk"}  # no device spans off the card
    valid = int(rows._tokens["attention_mask"].sum())
    assert sum(c["attrs"]["valid_tokens"] for c in chunks) == valid
    assert [c["attrs"]["computed_tokens"] for c in chunks] == [256 * 32, 256 * 32]
    profiling.reset_spans()
    exp._pool_tokens(rows._tokens)  # no profiler: nothing recorded
    assert profiling.spans() == []


def test_published_widths_build_on_meta_without_host_memory():
    def rss() -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    before = rss()
    module = DeepseekV3TextEncoder(DeepseekV3Config(), device="meta")
    grown = rss() - before
    count = sum(p.numel() for p in module.parameters())
    assert count == parameter_count(DeepseekV3Config()) == 15_624_565_888
    assert all(p.device.type == "meta" for p in module.parameters())
    assert grown < 64 * 2 ** 20, grown  # 31.25 GB of bf16 weights were not allocated
    assert len(hf_names(DeepseekV3Config())) == 26 * 64 * 3 + 27 * 7 + 3 + 26 * 5 + 2

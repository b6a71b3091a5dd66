"""The Kimi-Linear text tower (``models/kimi_linear.py``), the plain path of
its KDA scan (``ops/kda.py``), the NoPE path of the latent attention, the
held share of the MoE layer and the trainer's bank over the tower, held
against the plain reference ``tests/reference_kimi_linear.py`` at a tiny size
on the CPU (``torch_kimi_linear.TINY``: 3 KDA layers then 1 MLA, hidden 64,
4 heads of 16, 16 experts of which 8 are held, top-4).  Float32 towers match
to 1e-4 of the largest value (the chunked scan against the reference's token
loop: float32 sums in another order); bfloat16 ones within 1.5e-2 relative
by the median token and 3e-2 for nine tokens in ten (a token whose selection
sits at a near tie may flip), as the DeepSeek-V3 tower's tests."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import reference_kimi_linear as ref
from mmgclip_tpu_torch.models.deepseek_v3 import MoE, rope_tables
from mmgclip_tpu_torch.models.kimi_linear import (KimiLinearConfig, KimiLinearTextEncoder,
                                                  _KimiParams, hf_names, load_kimi_linear_weights,
                                                  parameter_count)
from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.ops.kda import CHUNK, kda, plain_kda, prepare, recurrent_kda
from mmgclip_tpu_torch.ops.mla_attention import mla_attention
from mmgclip_tpu_torch.ops.moe_experts import dispatch
from mmgclip_tpu_torch.ops.rms_norm import plain_rms_norm, rms_norm
from torch_kimi_linear import TINY, TINY_FIELDS, cfg_dict, hf_state_dict, hf_weights, tiny_override

FP32 = dataclasses.replace(TINY, dtype=torch.float32)


def tower(c: KimiLinearConfig, seed: int = 0, bias_std: float = 0.1):
    """-> (the port's tower loaded from ``hf_weights``, the weights in float32)."""
    weights = hf_weights(c, seed, bias_std)
    reference = {k: v.float() for k, v in weights.items()}
    module = KimiLinearTextEncoder(c, device="meta")
    load_kimi_linear_weights(module, weights)
    return module, reference


def ragged(b=4, s=12, lengths=(12, 7, 3, 1), seed=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, TINY.vocab_size, (b, s), generator=g)
    mask = (torch.arange(s)[None] < torch.tensor(lengths)[:, None]).to(torch.int32)
    return ids * mask, mask


# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_reference_under_ragged_padding(dtype):
    """The last hidden state at every valid position and the EOS-pooled
    feature against the reference, rows at their own lengths."""
    c = dataclasses.replace(TINY, dtype=dtype)
    # bf16: a selection bias of spread 1 keeps the tiny router (4 of 16, 8 of
    # them held) off the near ties that rounding flips (at 0.1, 3 of 23 tokens)
    module, weights = tower(c, bias_std=0.1 if dtype == torch.float32 else 1.0)
    ids, mask = ragged()
    with torch.no_grad():
        got = module(ids, attention_mask=mask)
    want = ref.forward(weights, cfg_dict(c), ids, mask)
    valid = mask > 0
    last = mask.sum(1) - 1
    pooled, pooled_ref = got[torch.arange(4), last], want[torch.arange(4), last]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    if dtype == torch.float32:
        assert float((got - want)[valid].abs().max() / want[valid].abs().max()) < 1e-4
        assert float((pooled - pooled_ref).abs().max() / pooled_ref.abs().max()) < 1e-4
        # a row alone, unpadded, gives what it gave inside the padded batch
        alone = module(ids[1:2, :7], attention_mask=mask[1:2, :7])
        torch.testing.assert_close(alone[0], got[1, :7], rtol=1e-5, atol=1e-5)
    else:
        errors = (got - want)[valid].norm(dim=1) / want[valid].norm(dim=1)
        assert float(errors.median()) < 1.5e-2 and float((errors > 3e-2).float().mean()) <= 0.1


def _inline_norm(x, weight, eps, dtype=None):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * weight.float()
    return out.to(x.dtype if dtype is None else dtype)


def _inline_gate(o, r, weight, eps, b, s, H, d):
    """The KDA layer's output gate as it ran inline before ``ops/rms_norm.py``:
    the gate widened and activated in float32, the per-head norm into float32,
    their product rounded to the tower's dtype."""
    gate = torch.sigmoid(r.float())
    y = _inline_norm(o.view(b, s, H, d), weight, eps, torch.float32) * gate.view(b, s, H, d)
    return y.to(o.dtype).view(b, s, H * d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_gated_norm_is_the_inline_gate(dtype):
    """``plain_rms_norm(..., gate=)`` over the per-head rows ``[b s H, d]``
    bit-equal to the gate the layer computed inline; ``rms_norm`` takes it
    for CPU tensors and launches nothing."""
    b, s, H, d = 3, 5, TINY.kda_num_heads, TINY.kda_head_dim
    g = torch.Generator().manual_seed(11)
    o = (2 * torch.randn(b, s, H * d, generator=g)).to(dtype)
    r = (3 * torch.randn(b, s, H * d, generator=g)).to(dtype)
    weight = (1 + 0.1 * torch.randn(d, generator=g)).to(dtype)
    want = _inline_gate(o, r, weight, 1e-5, b, s, H, d)
    got = plain_rms_norm(o.view(b * s * H, d), weight, 1e-5, gate=r.view(b * s * H, d))
    assert got.dtype == dtype and torch.equal(got.view(b, s, H * d), want)
    before = launch_counts()["rms_norm"]
    again = rms_norm(o.view(b * s * H, d), weight, 1e-5, gate=r.view(b * s * H, d))
    assert torch.equal(again.view(b, s, H * d), want)
    assert launch_counts()["rms_norm"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_tower_is_unchanged_by_its_norm_op(dtype, monkeypatch):
    """The tower's CPU output bit-equal to its output with every norm and
    the output gate computed inline, as before ``ops/rms_norm.py``."""
    from mmgclip_tpu_torch.models import deepseek_v3, kimi_linear

    module, _weights = tower(dataclasses.replace(TINY, dtype=dtype), bias_std=1.0)
    ids, mask = ragged()
    with torch.no_grad():
        got = module(ids, attention_mask=mask)

        def inline_norm(self, x, dtype=None, gate=None):
            if gate is None:
                return _inline_norm(x, self.weight, self.eps, dtype)
            rows, d = x.shape
            b, s = ids.shape
            H = rows // (b * s)
            return _inline_gate(x.view(b, s, H * d), gate.view(b, s, H * d), self.weight,
                                self.eps, b, s, H, d).view(rows, d)

        monkeypatch.setattr(deepseek_v3.RMSNorm, "forward", inline_norm)
        assert kimi_linear.RMSNorm is deepseek_v3.RMSNorm
        want = module(ids, attention_mask=mask)
    assert torch.equal(got, want)


def _scan_inputs(b, s, heads, d, seed, a_log=None):
    g = torch.Generator().manual_seed(seed)
    HD = heads * d
    q, k, v = (torch.randn(b, s, HD, generator=g) for _ in range(3))
    f = 0.3 * torch.randn(b, s, HD, generator=g)
    beta = torch.randn(b, s, heads, generator=g)
    convs = [torch.rand(HD, 4, generator=g) - 0.5 for _ in range(3)]
    if a_log is None:
        a_log = (1 + 15 * torch.rand(heads, generator=g)).log()
    dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(HD, generator=g))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return q, k, v, f, beta, *convs, a_log, dt_bias


@pytest.mark.parametrize("decay", ["strong", "mixed"])
def test_chunked_scan_matches_the_token_recurrence(decay):
    """The plain path's chunked form against the token-by-token recurrence
    over three chunks and a part, at lengths that are not multiples of the
    chunk, with the decay as strong as ``A_log`` = log 16 on every head (a
    chunk's cumulative log-decay reaches hundreds: relative exponents only);
    0 past each row's length, everything finite."""
    heads, d, s = 2, 16, 3 * CHUNK + 21
    a_log = torch.full((heads,), math.log(16.0)) if decay == "strong" else None
    inputs = _scan_inputs(3, s, heads, d, seed=7, a_log=a_log)
    if decay == "strong":
        inputs = list(inputs)
        inputs[3] = inputs[3] + 6.0  # softplus(f + dt_bias) ~ 6: g ~ -96 a token
    lengths = torch.tensor([s, CHUNK + 1, 2 * CHUNK - 5], dtype=torch.int32)
    got = plain_kda(*inputs, lengths)
    ops = prepare(*inputs, heads)
    want = recurrent_kda(*ops).transpose(1, 2).reshape(3, s, heads * d)
    assert torch.isfinite(got).all()
    if decay == "strong":
        G = torch.cumsum(ops[3][0, 0, :CHUNK], 0)
        assert float(G.min()) < -500  # exp of the cumulative sum alone would underflow
    for r, n in enumerate(lengths.tolist()):
        torch.testing.assert_close(got[r, :n], want[r, :n], rtol=1e-4, atol=1e-5)
        assert not got[r, n:].any()
    before = launch_counts()["kda"]
    assert torch.equal(kda(*inputs, lengths), got)  # CPU tensors: the plain path
    assert launch_counts()["kda"] == before


@pytest.mark.parametrize("variant", ["reset_every", "head_decay", "state_dtype"])
def test_scan_variants_are_what_they_say(variant):
    """The planted faults' variants: a state reset every 64 tokens equals
    each 64-token piece scanned alone from its own start (the convolutions'
    history kept); a head decay equals the scan over the head's mean g; a
    bf16 state stays within bf16's reach of the float32 one but differs."""
    heads, d, s = 2, 16, 2 * CHUNK + 9
    inputs = _scan_inputs(2, s, heads, d, seed=11)
    lengths = torch.tensor([s, s - 40], dtype=torch.int32)
    sound = plain_kda(*inputs, lengths)
    ops = prepare(*inputs, heads)
    if variant == "reset_every":
        got = plain_kda(*inputs, lengths, reset_every=CHUNK)
        pieces = [recurrent_kda(*(t[:, :, c0:c0 + CHUNK] for t in ops))
                  for c0 in range(0, s, CHUNK)]
        want = torch.cat(pieces, dim=2).transpose(1, 2).reshape(2, s, heads * d)
    elif variant == "head_decay":
        got = plain_kda(*inputs, lengths, head_decay=True)
        q, k, v, g, beta = ops
        want = recurrent_kda(q, k, v, g.mean(-1, keepdim=True).expand_as(g), beta)
        want = want.transpose(1, 2).reshape(2, s, heads * d)
    else:
        got = plain_kda(*inputs, lengths, state_dtype=torch.bfloat16)
        assert float((got - sound).norm() / sound.norm()) < 3e-2
        assert not torch.equal(got, sound)
        return
    valid = torch.arange(s)[None] < lengths[:, None]
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-4, atol=1e-5)
    assert float((got - sound)[valid].norm() / sound[valid].norm()) > 1e-2


def test_nope_mla_is_rotated_mla_at_position_zero():
    """Without tables the attention leaves q_pe and k_pe unrotated: at
    position 0 (where RoPE turns by 0) it is the rotated attention; past it,
    it is the rotated attention over unrotated operands, and not the rotated
    one."""
    H, nope, rope, vd, s = 4, 16, 8, 16, 9
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, s, H * (nope + rope), generator=g)
    k_pe = torch.randn(2, s, rope, generator=g)
    kv = torch.randn(2, s, H * (nope + vd), generator=g)
    keys = torch.ones(2, s, dtype=torch.int32)
    cos, sin = rope_tables(s, rope, 10000.0, "cpu")
    nope_out = mla_attention(q, k_pe, kv, None, None, keys, H)
    rotated = mla_attention(q, k_pe, kv, cos, sin, keys, H)
    torch.testing.assert_close(nope_out[:, 0], rotated[:, 0], rtol=1e-6, atol=1e-6)
    identity = mla_attention(q, k_pe, kv, torch.ones_like(cos), torch.zeros_like(sin), keys, H)
    torch.testing.assert_close(nope_out, identity, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(nope_out[:, 1:], rotated[:, 1:], rtol=1e-3, atol=1e-3)


def _moe(c, held, seed=1):
    """A MoE layer holding ``held`` of a router drawn from ``seed`` (the same
    router and experts whatever ``held``)."""
    ds = c.deepseek()
    full = MoE(ds, _KimiParams(ds, torch.device("cpu"), torch.Generator().manual_seed(seed)))
    part = MoE(ds, _KimiParams(ds, torch.device("meta"), None), held)
    with torch.no_grad():
        for name, p in full.named_parameters():
            value = p[held.start:held.stop] if name in ("w_gate_up", "w_down") else p
            parent, _, leaf = name.rpartition(".")
            owner = part.get_submodule(parent) if parent else part
            setattr(owner, leaf, torch.nn.Parameter(value.clone(), requires_grad=False))
    return full, part


def test_the_held_shares_add_up_to_the_uncut_layer():
    """Two complementary shares of the experts (each routing over all 16,
    normalizing over all 4 chosen), with the shared expert counted once, add
    up to the layer that holds every expert; a share computes rows only for
    its own experts."""
    c = dataclasses.replace(FP32, experts_held=(0, 16))
    full, low = _moe(c, range(0, 8))
    _, high = _moe(c, range(8, 16))
    x = torch.randn(1, 40, c.hidden_size, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        whole, a, b = full(x), low(x), high(x)
        shared = full.shared_experts(x.view(40, -1)).view_as(x)
    torch.testing.assert_close(a + b - shared, whole, rtol=1e-5, atol=1e-5)
    chosen, _w = full.route(x.view(40, -1))
    plan = dispatch(chosen, 16, range(8, 16))
    assert not plan.complete and plan.counts.shape == (8,)
    assert int(plan.counts.sum()) == int((chosen >= 8).sum())
    assert int(plan.offsets[-1]) == int((chosen >= 8).sum())  # no tile past the held rows


def test_hf_loader_round_trip_is_strict():
    weights = hf_weights(TINY, seed=4)
    module = KimiLinearTextEncoder(TINY, device="meta")
    given = dict(weights, **{"lm_head.weight": torch.zeros(3)})
    read = load_kimi_linear_weights(module, given)
    assert sorted(read) == sorted(hf_names(TINY))
    # experts this tower does not hold are left, as lm_head is
    assert set(given) == {"lm_head.weight"} | {
        n for n in weights if ".experts." in n and int(n.split(".experts.")[1].split(".")[0]) >= 8}
    assert not any(p.is_meta for p in module.parameters())
    back = hf_state_dict(module)
    assert sorted(back) == sorted(f"model.{n}" for n in hf_names(TINY))
    for name, value in back.items():
        assert torch.equal(value, weights[name]), name
    layer = module.layers[0].self_attn
    assert layer.A_log.dtype == torch.float32 and layer.dt_bias.dtype == torch.float32
    assert tuple(layer.q_conv1d.shape) == (64, 1, 4)
    incomplete = dict(weights)
    incomplete.pop("model.layers.1.self_attn.dt_bias")
    with pytest.raises(KeyError, match="missing"):
        load_kimi_linear_weights(KimiLinearTextEncoder(TINY, device="meta"), incomplete)
    with pytest.raises(KeyError, match="not a Kimi-Linear"):
        load_kimi_linear_weights(KimiLinearTextEncoder(TINY, device="meta"),
                                 dict(weights, **{"model.layers.0.self_attn.q_norm.weight":
                                                  torch.zeros(3)}))


@pytest.mark.parametrize("key,value", [("mla_use_nope", False), ("short_conv_kernel_size", 3),
                                       ("q_lora_rank", 1536), ("num_expert_group", 2),
                                       ("moe_router_activation_func", "softmax")])
def test_from_overrides_refuses_a_key_taken_at_one_value(key, value):
    published = {"hidden_size": 64, "linear_attn_config": {"kda_layers": [1, 2, 3],
                                                           "full_attn_layers": [4],
                                                           "short_conv_kernel_size": 4},
                 "num_hidden_layers": 4}
    c = KimiLinearConfig.from_overrides(published)
    assert c.kda_layers == (1, 2, 3) and c.hidden_size == 64
    if key == "short_conv_kernel_size":
        published["linear_attn_config"] = dict(published["linear_attn_config"], **{key: value})
    else:
        published[key] = value
    with pytest.raises(ValueError, match=key):
        KimiLinearConfig.from_overrides(published)


def test_the_schedule_and_the_published_size():
    c = KimiLinearConfig(experts_held=(0, 128))
    assert [i for i in range(27) if not c.is_kda(i)] == [3, 7, 11, 15, 19, 23, 26]
    assert parameter_count(c) == 25_190_065_024
    module = KimiLinearTextEncoder(c, device="meta")
    assert all(p.device.type == "meta" for p in module.parameters())
    assert tuple(module.layers[1].mlp.w_down.shape) == (128, 2304, 1024)
    assert tuple(module.layers[1].mlp.gate.shape) == (256, 2304)
    with pytest.raises(ValueError, match="split"):
        KimiLinearConfig(kda_layers=(1, 2), full_attn_layers=(4,), num_hidden_layers=4)


class _Rows:
    def __init__(self, features, tokens):
        self._features, self._tokens = features, tokens

    def __len__(self):
        return len(self._features)


def _bank_rows(seed, n=12, s=40):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 33, n)
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(0, TINY.vocab_size, (n, s)).astype(np.int32) * mask
    return _Rows(rng.normal(size=(n, 768)).astype(np.float32),
                 {"input_ids": ids, "attention_mask": mask})


def test_the_trainer_banks_reports_through_the_tower(tmp_path):
    """``networks=clip_convnext_kimi_linear_text``: the trainer builds the
    tower on ``meta``, takes the weights over and banks each row's EOS
    feature as the reference pools it."""
    from mmgclip_tpu_torch.cli import DEFAULT_CONFIG_DIR
    from mmgclip_tpu_torch.config import compose
    from mmgclip_tpu_torch.data.loader import DataLoader
    from mmgclip_tpu_torch.models.kimi_linear import KimiLinearTextEncoder as Tower
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment

    weights = hf_weights(FP32, seed=5)
    reference = {k: v.clone() for k, v in weights.items()}
    rows = _bank_rows(6)
    cfg = compose(DEFAULT_CONFIG_DIR, "train_binary_class_clf",
                  ["networks=clip_convnext_kimi_linear_text", "projection=2xLinear512",
                   tiny_override("float32"), "dataloader.train.batch_size=4", "base.seed=0"],
                  run_dir=str(tmp_path))
    cfg.base.tensorboard_export_dir = str(tmp_path / "tb")
    exp = ClassifierExperiment(config=cfg, train_dataloader=DataLoader(rows, batch_size=4,
                                                                       drop_last=True),
                               device="cpu", text_weights=weights)
    assert isinstance(exp.model.text_module, Tower)
    assert exp.model.text_module.config == FP32
    ids = torch.as_tensor(rows._tokens["input_ids"])
    mask = torch.as_tensor(rows._tokens["attention_mask"])
    hidden = ref.forward(reference, cfg_dict(FP32), ids, mask)
    want = hidden[torch.arange(len(ids)), mask.sum(1) - 1]
    torch.testing.assert_close(exp._text_bank, want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(exp.train())


def test_tiny_override_names_every_field():
    assert all(k in tiny_override() for k in TINY_FIELDS if not k.startswith("kda_"))

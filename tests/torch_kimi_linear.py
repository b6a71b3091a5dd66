"""The Kimi-Linear text tower's test size, its weights under HF names and its
configuration under the published keys, shared by ``test_torch_kimi_linear.py``
(the CPU) and ``test_torch_cuda.py`` (the card)."""

import math
from typing import Dict

import torch

from mmgclip_tpu_torch.models.kimi_linear import (KimiLinearConfig, KimiLinearTextEncoder,
                                                  _hf_name, hf_names)

# 3 KDA layers then 1 MLA (the published 3 : 1 period), layer 0 dense, 16
# experts of which 8 are held, top-4, 1 shared; KDA 4 heads of 16, MLA latent
# 16, rope 8
TINY_FIELDS = dict(vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                   num_hidden_layers=4, num_attention_heads=4, kv_lora_rank=16,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, num_experts=16,
                   num_shared_experts=1, num_experts_per_token=4, kda_layers=(1, 2, 3),
                   full_attn_layers=(4,), kda_num_heads=4, kda_head_dim=16, experts_held=(0, 8))
TINY = KimiLinearConfig(**TINY_FIELDS)


def tiny_override(dtype: str = "bfloat16", **fields) -> str:
    """``TINY`` (with ``fields`` changed) as a ``networks.text_encoder.config``
    override, ``linear_attn_config`` under its published keys."""
    f = dict(TINY_FIELDS, **fields)
    linear = (f"linear_attn_config: {{kda_layers: {list(f.pop('kda_layers'))}, "
              f"full_attn_layers: {list(f.pop('full_attn_layers'))}, "
              f"num_heads: {f.pop('kda_num_heads')}, head_dim: {f.pop('kda_head_dim')}, "
              f"short_conv_kernel_size: 4}}")
    keys = ", ".join(f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in f.items())
    return "networks.text_encoder.config={" + keys + ", " + linear + f", dtype: {dtype}}}"


def cfg_dict(c: KimiLinearConfig) -> Dict:
    """``c`` under the published keys, as the plain reference reads it."""
    return {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "intermediate_size": c.intermediate_size,
            "moe_intermediate_size": c.moe_intermediate_size,
            "num_hidden_layers": c.num_hidden_layers, "num_attention_heads": c.num_attention_heads,
            "kv_lora_rank": c.kv_lora_rank, "qk_nope_head_dim": c.qk_nope_head_dim,
            "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim,
            "num_shared_experts": c.num_shared_experts,
            "num_experts_per_token": c.num_experts_per_token,
            "first_k_dense_replace": c.first_k_dense_replace,
            "routed_scaling_factor": c.routed_scaling_factor, "moe_renormalize": c.moe_renormalize,
            "rms_norm_eps": c.rms_norm_eps,
            "linear_attn_config": {"kda_layers": list(c.kda_layers),
                                   "full_attn_layers": list(c.full_attn_layers),
                                   "num_heads": c.kda_num_heads, "head_dim": c.kda_head_dim,
                                   "short_conv_kernel_size": 4},
            "router_experts": c.num_experts, "experts_held": list(c.experts_held),
            "router_dtype": c.dtype}


def hf_state_dict(module: KimiLinearTextEncoder) -> Dict[str, torch.Tensor]:
    """The tower's weights under HF names (``model.`` prefixed), the held
    experts unstacked (views of the stacks)."""
    c = module.config
    I = c.moe_intermediate_size
    out = {}
    for name, p in module.named_parameters():
        stem, _, leaf = name.rpartition(".")
        if leaf in ("w_gate_up", "w_down"):
            for row, j in enumerate(c.held):
                if leaf == "w_gate_up":
                    out[f"model.{stem}.experts.{j}.gate_proj.weight"] = p[row, :I]
                    out[f"model.{stem}.experts.{j}.up_proj.weight"] = p[row, I:]
                else:
                    out[f"model.{stem}.experts.{j}.down_proj.weight"] = p[row]
        else:
            out["model." + _hf_name(name)] = p
    return out


def hf_weights(c: KimiLinearConfig, seed: int = 0, bias_std: float = 0.1) -> Dict:
    """HF-named weights, every routed expert of the router (held or not):
    projections at 1 / sqrt(fan in), norms 1 +- 0.1, the selection bias at
    ``bias_std``, ``A_log`` = log U(1, 16), softplus(``dt_bias``) log-uniform in
    [1e-3, 1e-1], the convolutions U(-0.5, 0.5), the gate's bias at 0.1;
    rounded to the tower's dtype but ``A_log``, ``dt_bias`` and the bias."""
    g = torch.Generator().manual_seed(seed)
    whole = KimiLinearConfig(**{**TINY_FIELDS, **_fields(c), "experts_held": (0, c.num_experts)})
    donor = hf_state_dict(KimiLinearTextEncoder(whole, device="meta"))
    out = {}
    for name in hf_names(whole):
        shape = tuple(donor["model." + name].shape)
        if name.endswith("e_score_correction_bias"):
            t = torch.randn(shape, generator=g) * bias_std
        elif name.endswith("A_log"):
            t = (1 + 15 * torch.rand(shape, generator=g)).log()
        elif name.endswith("dt_bias"):
            dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(shape, generator=g))
            t = dt + torch.log(-torch.expm1(-dt))
        elif name.endswith("conv1d.weight"):
            t = torch.rand(shape, generator=g) - 0.5
        elif name.endswith("norm.weight"):
            t = 1 + 0.1 * torch.randn(shape, generator=g)
        elif name.endswith(".bias"):
            t = 0.1 * torch.randn(shape, generator=g)
        else:
            t = torch.randn(shape, generator=g) / (1.0 if "embed" in name else shape[-1] ** 0.5)
        keep = name.endswith(("e_score_correction_bias", "A_log", "dt_bias"))
        out["model." + name] = t if keep else t.to(c.dtype)
    return out


def _fields(c: KimiLinearConfig) -> Dict:
    return {k: getattr(c, k) for k in TINY_FIELDS}

"""The DeepSeek-V3 text tower's test size and its weights under HF names,
shared by ``test_torch_deepseek_v3.py`` (the CPU) and ``test_torch_cuda.py``
(the card)."""

from typing import Dict

import torch

from mmgclip_tpu_torch.models.deepseek_v3 import DeepseekV3Config, DeepseekV3TextEncoder, _hf

# 1 dense + 2 MoE layers, 8 experts, top-2, 1 shared expert, latent 16, rope 8
TINY_FIELDS = dict(vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                   num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=16,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                   n_shared_experts=1, num_experts_per_tok=2, max_position_embeddings=128)
TINY = DeepseekV3Config(**TINY_FIELDS)


def tiny_override(dtype: str = "bfloat16") -> str:
    """``TINY`` as a ``networks.text_encoder.config`` override."""
    keys = ", ".join(f"{k}: {v}" for k, v in TINY_FIELDS.items())
    return "networks.text_encoder.config={" + keys + f", dtype: {dtype}}}"


def hf_state_dict(module: DeepseekV3TextEncoder) -> Dict[str, torch.Tensor]:
    """The tower's weights under HF names (``model.`` prefixed), the routed
    experts unstacked (views of the stacks)."""
    c = module.config
    I = c.moe_intermediate_size
    out = {}
    for name, p in module.named_parameters():
        stem, _, leaf = name.rpartition(".")
        if leaf == "w_gate_up":
            for j in range(c.n_routed_experts):
                out[f"model.{stem}.experts.{j}.gate_proj.weight"] = p[j, :I]
                out[f"model.{stem}.experts.{j}.up_proj.weight"] = p[j, I:]
        elif leaf == "w_down":
            for j in range(c.n_routed_experts):
                out[f"model.{stem}.experts.{j}.down_proj.weight"] = p[j]
        else:
            out["model." + _hf(name)] = p
    return out

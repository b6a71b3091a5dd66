"""Causal (decoder-only) text tower, the BioGPT ablation family (port of
mmgclip_tpu/models/gpt.py).

BioGPT's topology: scaled token embeddings (sqrt(d) * tok), OPT-style
learned positions ``cumsum(mask) * mask - 1 + 2`` (0-based over the valid
tokens, padded steps pinned to offset - 1), pre-LN blocks with causal and
padding attention (scores in fp32, masked to ``NEG_INF``, then softmax),
exact-erf GELU, a final flax LayerNorm.  Returns ``last_hidden_state``; the
CLIP head's EOS pooling picks the last valid token.  Attention is plain
``torch.matmul``: the JAX tower computes it outside any Pallas kernel, and
the port's flash kernel has no causal mask.

The parameters keep the JAX layout and names, stacked over layers
(``qkv_kernel`` is ``[L, H, 3H]``), so ``weights.load_flax_tree`` carries a
flax tree across; ``load_biogpt_weights`` maps a HuggingFace ``BioGptModel``
state dict onto them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import NEG_INF
from ._params import ParamGroup, flax_layer_norm, layer_norm, lecun_normal, norm, weight


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 42384  # microsoft/biogpt vocabulary
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    scale_embedding: bool = True
    position_offset: int = 2  # OPT/BioGPT learned-position offset
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "GPTConfig":
        return GPTConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=64)


STACKED = ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias", "attn_norm_scale", "attn_norm_bias",
           "mlp_in_kernel", "mlp_in_bias", "mlp_out_kernel", "mlp_out_bias", "mlp_norm_scale",
           "mlp_norm_bias")


class CausalTextEncoder(nn.Module):
    """Embeddings + pre-LN causal blocks over stacked params; returns last_hidden_state."""

    def __init__(self, config: GPTConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
        # flax nn.Embed's default init: normal with variance 1 / width
        self.embed_tokens = ParamGroup(embedding=torch.randn(cfg.vocab_size, H, generator=g) / math.sqrt(H))
        self.embed_positions = ParamGroup(embedding=torch.randn(
            cfg.max_position_embeddings + cfg.position_offset, H, generator=g) / math.sqrt(H))
        stacked = {
            "qkv_kernel": lecun_normal((L, H, 3 * H), H, g),
            "qkv_bias": torch.zeros(L, 3 * H),
            "out_kernel": lecun_normal((L, H, H), H, g),
            "out_bias": torch.zeros(L, H),
            "attn_norm_scale": torch.ones(L, H),
            "attn_norm_bias": torch.zeros(L, H),
            "mlp_in_kernel": lecun_normal((L, H, I), H, g),
            "mlp_in_bias": torch.zeros(L, I),
            "mlp_out_kernel": lecun_normal((L, I, H), I, g),
            "mlp_out_bias": torch.zeros(L, H),
            "mlp_norm_scale": torch.ones(L, H),
            "mlp_norm_bias": torch.zeros(L, H),
        }
        for name in STACKED:
            self.register_parameter(name, nn.Parameter(stacked[name]))
        self.final_norm = norm(H)

    def _layer(self, hidden: torch.Tensor, i: int, mask: torch.Tensor) -> torch.Tensor:
        """One pre-LN block over layer ``i``'s parameters."""
        cfg = self.config
        b, s, H = hidden.shape
        heads = cfg.num_attention_heads
        dt, eps = cfg.dtype, cfg.layer_norm_eps
        x = layer_norm(hidden, self.attn_norm_scale[i], self.attn_norm_bias[i], eps)
        qkv = x @ weight(self.qkv_kernel[i], dt, x) + weight(self.qkv_bias[i], dt, x)
        qkv = qkv.reshape(b, s, 3, heads, H // heads)
        q, k, v = (qkv[:, :, j].permute(0, 2, 1, 3) for j in range(3))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / torch.sqrt(torch.tensor(H // heads, dtype=scores.dtype, device=scores.device))
        scores = torch.where(mask, scores, torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs.to(v.dtype), v).permute(0, 2, 1, 3).reshape(b, s, H)
        hidden = hidden + (ctx @ weight(self.out_kernel[i], dt, ctx) + weight(self.out_bias[i], dt, ctx))
        x = layer_norm(hidden, self.mlp_norm_scale[i], self.mlp_norm_bias[i], eps)
        x = x @ weight(self.mlp_in_kernel[i], dt, x) + weight(self.mlp_in_bias[i], dt, x)
        x = nn.functional.gelu(x, approximate="none")
        return hidden + (x @ weight(self.mlp_out_kernel[i], dt, x) + weight(self.mlp_out_bias[i], dt, x))

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        b, s = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=device)
        attention_mask = attention_mask.long()
        tok = self.embed_tokens.embedding[input_ids.long()]
        if cfg.scale_embedding:
            tok = tok * torch.sqrt(torch.tensor(cfg.hidden_size, dtype=tok.dtype, device=device))
        positions = torch.cumsum(attention_mask, dim=1) * attention_mask - 1 + cfg.position_offset
        hidden = (tok + self.embed_positions.embedding[positions]).to(cfg.dtype)
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=device))
        mask = causal[None, None] & (attention_mask[:, None, None, :] > 0)  # [b, 1, s, s]
        for i in range(cfg.num_hidden_layers):
            hidden = self._layer(hidden, i, mask)
        return flax_layer_norm(hidden, self.final_norm.scale, self.final_norm.bias, cfg.layer_norm_eps)


@torch.no_grad()
def load_biogpt_weights(module: CausalTextEncoder, torch_state_dict: Dict[str, Any]) -> CausalTextEncoder:
    """Map a HuggingFace ``BioGptModel`` state dict onto the stacked params,
    in place (the JAX package's ``load_biogpt_weights``)."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in torch_state_dict.items()}
    module.embed_tokens.embedding.copy_(sd["embed_tokens.weight"])
    module.embed_positions.embedding.copy_(sd["embed_positions.weight"])
    module.final_norm.scale.copy_(sd["layer_norm.weight"])
    module.final_norm.bias.copy_(sd["layer_norm.bias"])
    sources = {
        "qkv_kernel": lambda p: torch.cat([sd[f"{p}.self_attn.{n}_proj.weight"].T for n in "qkv"], dim=1),
        "qkv_bias": lambda p: torch.cat([sd[f"{p}.self_attn.{n}_proj.bias"] for n in "qkv"]),
        "out_kernel": lambda p: sd[f"{p}.self_attn.out_proj.weight"].T,
        "out_bias": lambda p: sd[f"{p}.self_attn.out_proj.bias"],
        "attn_norm_scale": lambda p: sd[f"{p}.self_attn_layer_norm.weight"],
        "attn_norm_bias": lambda p: sd[f"{p}.self_attn_layer_norm.bias"],
        "mlp_in_kernel": lambda p: sd[f"{p}.fc1.weight"].T,
        "mlp_in_bias": lambda p: sd[f"{p}.fc1.bias"],
        "mlp_out_kernel": lambda p: sd[f"{p}.fc2.weight"].T,
        "mlp_out_bias": lambda p: sd[f"{p}.fc2.bias"],
        "mlp_norm_scale": lambda p: sd[f"{p}.final_layer_norm.weight"],
        "mlp_norm_bias": lambda p: sd[f"{p}.final_layer_norm.bias"],
    }
    for name, source in sources.items():
        getattr(module, name).copy_(torch.stack(
            [source(f"layers.{i}") for i in range(module.config.num_hidden_layers)]))
    return module

"""BERT-style text tower in PyTorch (port of mmgclip_tpu/models/bert.py).

Returns ``last_hidden_state``; EOS pooling happens in the CLIP head.  The
parameters keep the JAX layout, stacked over layers: ``qkv_kernel`` is
``[L, H, 3, heads, dh]``.  ``BertConfig.use_flash_attention`` routes
attention through ``ops.flash_attention`` (the CUDA kernel on the card);
the default is the plain attention, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import attention_reference, flash_attention, prefix_lengths
from ._params import ParamGroup, flax_layer_norm, host_array, layer_norm, lecun_normal, norm, weight


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 28996  # Bio_ClinicalBERT / bert-base-cased vocabulary
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # opt-in, as in the JAX package; set by constructing the config (the
    # JAX package's config files do not reach it either, see ROADMAP.md)
    use_flash_attention: bool = False
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "BertConfig":
        """A small config for tests and CPU smoke runs."""
        return BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          max_position_embeddings=128)


STACKED = ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias", "attn_norm_scale", "attn_norm_bias",
           "mlp_in_kernel", "mlp_in_bias", "mlp_out_kernel", "mlp_out_bias", "out_norm_scale",
           "out_norm_bias")


def bert_layer(hidden: torch.Tensor, p: Dict[str, torch.Tensor], attend, cfg: BertConfig,
               reduce=None) -> torch.Tensor:
    """One post-LN transformer block over one layer's parameters ``p``.
    ``reduce`` (the tensor-parallel all-reduce) runs on the attention output
    and the second MLP product before their biases; ``p`` may hold a block
    of the heads and of the MLP's hidden units."""
    b, s, _H = hidden.shape
    dt = cfg.dtype
    qkv = torch.einsum("bsh,hknd->bsknd", hidden, weight(p["qkv_kernel"], dt, hidden))
    qkv = qkv + weight(p["qkv_bias"], dt, hidden)
    q, k, v = (qkv[:, :, j].permute(0, 2, 1, 3) for j in range(3))
    ctx = attend(q, k, v).permute(0, 2, 1, 3).reshape(b, s, -1)
    attn = ctx @ weight(p["out_kernel"], dt, ctx)
    if reduce is not None:
        attn = reduce(attn)
    attn = attn + weight(p["out_bias"], dt, ctx)
    hidden = layer_norm(hidden + attn, p["attn_norm_scale"], p["attn_norm_bias"], cfg.layer_norm_eps)
    mlp = hidden @ weight(p["mlp_in_kernel"], dt, hidden) + weight(p["mlp_in_bias"], dt, hidden)
    mlp = nn.functional.gelu(mlp, approximate="none")
    mlp = mlp @ weight(p["mlp_out_kernel"], dt, mlp)
    if reduce is not None:
        mlp = reduce(mlp)
    mlp = mlp + weight(p["mlp_out_bias"], dt, mlp)
    return layer_norm(hidden + mlp, p["out_norm_scale"], p["out_norm_bias"], cfg.layer_norm_eps)


def _embedding(rows: int, width: int, generator: torch.Generator) -> ParamGroup:
    # flax nn.Embed's default init: normal with variance 1/width
    return ParamGroup(embedding=torch.randn(rows, width, generator=generator) / math.sqrt(width))


class BertEncoder(nn.Module):
    """Embeddings + transformer stack; returns last_hidden_state."""

    def __init__(self, config: BertConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
        heads = cfg.num_attention_heads
        dh = H // heads
        self.word_embeddings = _embedding(cfg.vocab_size, H, g)
        self.position_embeddings = _embedding(cfg.max_position_embeddings, H, g)
        self.token_type_embeddings = _embedding(cfg.type_vocab_size, H, g)
        self.embeddings_norm = norm(H)
        stacked = {
            "qkv_kernel": lecun_normal((L, H, 3, heads, dh), H, g),
            "qkv_bias": torch.zeros(L, 3, heads, dh),
            "out_kernel": lecun_normal((L, H, H), H, g),
            "out_bias": torch.zeros(L, H),
            "attn_norm_scale": torch.ones(L, H),
            "attn_norm_bias": torch.zeros(L, H),
            "mlp_in_kernel": lecun_normal((L, H, I), H, g),
            "mlp_in_bias": torch.zeros(L, I),
            "mlp_out_kernel": lecun_normal((L, I, H), I, g),
            "mlp_out_bias": torch.zeros(L, H),
            "out_norm_scale": torch.ones(L, H),
            "out_norm_bias": torch.zeros(L, H),
        }
        for name, value in stacked.items():
            self.register_parameter(name, nn.Parameter(value))

    def layer_params(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s slice of every stacked parameter."""
        return {name: getattr(self, name)[i] for name in STACKED}

    def _layer(self, hidden: torch.Tensor, i: int, attend) -> torch.Tensor:
        """One post-LN transformer block over layer ``i``'s parameters."""
        return bert_layer(hidden, self.layer_params(i), attend, self.config)

    def embed(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The three table lookups and the embeddings' LayerNorm."""
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids, dtype=torch.int64)
        hidden = (self.word_embeddings.embedding[input_ids.long()]
                  + self.position_embeddings.embedding[:s][None]
                  + self.token_type_embeddings.embedding[token_type_ids.long()])
        return flax_layer_norm(hidden, self.embeddings_norm.scale, self.embeddings_norm.bias,
                               self.config.layer_norm_eps)

    def _attention(self, mask: torch.Tensor, s: int):
        """The attention function every layer uses for this batch.  With
        flash on a CUDA batch, the mask's prefix lengths are computed once
        here instead of once per layer."""
        if not self.config.use_flash_attention:
            return lambda q, k, v: attention_reference(q, k, v, mask)
        if not mask.is_cuda:
            return lambda q, k, v: flash_attention(q, k, v, mask)
        lengths = prefix_lengths(mask, s)
        if lengths is None:  # not a contiguous prefix: the exact plain path
            return lambda q, k, v: attention_reference(q, k, v, mask)
        return lambda q, k, v: flash_attention(q, k, v, lengths=lengths)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        b, s = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=device)
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.int64, device=device)
        hidden = self.embed(input_ids, token_type_ids)
        attend = self._attention(attention_mask, s)
        for i in range(cfg.num_hidden_layers):
            hidden = self._layer(hidden, i, attend)
        return hidden


def trim_padded_tail(text_tokens: Dict, multiple: int = 32) -> Dict:
    """Drop all-padding tail columns from a right-padded token batch.

    Trims to the batch's longest valid row rounded up to ``multiple``;
    numerically exact (masked keys contribute zero, position embeddings are
    absolute over the valid prefix, everything else is per token).  Takes
    numpy arrays or tensors; a tensor mask costs one read back."""
    if not multiple:
        return text_tokens
    ids = text_tokens.get("input_ids")
    mask = text_tokens.get("attention_mask")
    if ids is None or mask is None:
        return text_tokens
    s = ids.shape[-1]
    host_mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    lens = host_mask.sum(axis=-1)
    target = int(-(-max(int(lens.max(initial=1)), 1) // multiple) * multiple)
    if target >= s:
        return text_tokens
    return {k: v[..., :target] if getattr(v, "ndim", 0) >= 1 and v.shape[-1] == s else v
            for k, v in text_tokens.items()}


def eos_pool(last_hidden_state: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Pool the final non-pad token per sequence (``sum(mask) - 1``)."""
    eos_idx = attention_mask.sum(dim=-1).long() - 1
    eos_idx = eos_idx.clamp(0, last_hidden_state.shape[1] - 1)
    return last_hidden_state[torch.arange(last_hidden_state.shape[0], device=eos_idx.device), eos_idx]


def hf_tree(state_dict, config: BertConfig) -> dict:
    """A HuggingFace ``BertModel`` state dict (without the ``bert.`` prefix)
    -> the JAX tower's numpy tree ``{"params": {...}}`` (the JAX package's
    ``load_hf_weights`` without the flax init it overwrites: every leaf of
    that init comes from the state dict).

    Per-layer tensors stack along a leading ``[layers]`` axis; the query,
    key and value projections fuse into ``qkv_kernel`` ``[H, 3, heads, dh]``
    and ``qkv_bias`` ``[3, heads, dh]`` per layer.
    """
    sd = {k: host_array(v) for k, v in state_dict.items()}
    H, heads = config.hidden_size, config.num_attention_heads
    dh = H // heads

    def per_head(pre, name):  # HF [H_out, H_in] -> [H_in, heads, dh]
        return sd[f"{pre}.attention.self.{name}.weight"].T.reshape(H, heads, dh)

    leaves = {
        "qkv_kernel": lambda pre: np.stack([per_head(pre, n) for n in ("query", "key", "value")],
                                           axis=1),
        "qkv_bias": lambda pre: np.stack([sd[f"{pre}.attention.self.{n}.bias"].reshape(heads, dh)
                                          for n in ("query", "key", "value")]),
        "out_kernel": lambda pre: sd[f"{pre}.attention.output.dense.weight"].T,
        "out_bias": lambda pre: sd[f"{pre}.attention.output.dense.bias"],
        "attn_norm_scale": lambda pre: sd[f"{pre}.attention.output.LayerNorm.weight"],
        "attn_norm_bias": lambda pre: sd[f"{pre}.attention.output.LayerNorm.bias"],
        "mlp_in_kernel": lambda pre: sd[f"{pre}.intermediate.dense.weight"].T,
        "mlp_in_bias": lambda pre: sd[f"{pre}.intermediate.dense.bias"],
        "mlp_out_kernel": lambda pre: sd[f"{pre}.output.dense.weight"].T,
        "mlp_out_bias": lambda pre: sd[f"{pre}.output.dense.bias"],
        "out_norm_scale": lambda pre: sd[f"{pre}.output.LayerNorm.weight"],
        "out_norm_bias": lambda pre: sd[f"{pre}.output.LayerNorm.bias"],
    }
    layers = [f"encoder.layer.{i}" for i in range(config.num_hidden_layers)]
    p = {
        "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
        "embeddings_norm": {"scale": sd["embeddings.LayerNorm.weight"],
                            "bias": sd["embeddings.LayerNorm.bias"]},
    }
    p.update({key: np.stack([leaf(pre) for pre in layers]) for key, leaf in leaves.items()})
    return {"params": p}

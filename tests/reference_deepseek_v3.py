"""A plain float32 reference of the DeepSeek-V3 text tower for the CPU tests,
written after HuggingFace's ``modeling_deepseek.py`` (``q_lora_rank`` None,
sigmoid ``noaux_tc`` routing with one group, no RoPE scaling): batched rows
under a causal and padding mask, RoPE by de-interleaving each head's rope
part and ``rotate_half``, the routed experts by a loop over experts with
``index_add``.  Plain ``torch`` over an HF-named state dict; it imports no
JAX and nothing of the port.  Returns the final RMSNorm's hidden states
(no ``lm_head``)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def apply_rope(x, positions, dim, theta):
    """HF DeepSeek: de-interleave (x0, x2, ..., x1, x3, ...), then rotate_half."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freqs = positions[:, None].float() * inv_freq[None]
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = emb.cos()[None, None], emb.sin()[None, None]
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + rotate_half(x) * sin


def mlp(x, sd, prefix):
    return F.linear(F.silu(F.linear(x, sd[prefix + "gate_proj.weight"]))
                    * F.linear(x, sd[prefix + "up_proj.weight"]), sd[prefix + "down_proj.weight"])


def moe(x, sd, p, cfg):
    b, s, d = x.shape
    flat = x.reshape(-1, d)
    scores = torch.sigmoid(F.linear(flat, sd[p + "gate.weight"]))
    choice = scores + sd[p + "gate.e_score_correction_bias"][None]
    topk_idx = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1, sorted=False).indices
    topk_weight = scores.gather(1, topk_idx)
    if cfg["num_experts_per_tok"] > 1 and cfg["norm_topk_prob"]:
        topk_weight = topk_weight / (topk_weight.sum(dim=-1, keepdim=True) + 1e-20)
    topk_weight = topk_weight * cfg["routed_scaling_factor"]
    y = torch.zeros_like(flat)
    for e in range(cfg["n_routed_experts"]):
        token, slot = torch.where(topk_idx == e)
        if len(token):
            out = mlp(flat[token], sd, f"{p}experts.{e}.")
            y.index_add_(0, token, out * topk_weight[token, slot, None])
    if cfg["n_shared_experts"]:
        y = y + mlp(flat, sd, p + "shared_experts.")
    return y.view(b, s, d)


def attention(x, sd, p, cfg, mask):
    b, s, _ = x.shape
    H, nope, rope, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    q = F.linear(x, sd[p + "q_proj.weight"]).view(b, s, H, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    ckv = F.linear(x, sd[p + "kv_a_proj_with_mqa.weight"])
    ckv, k_pe = ckv.split([cfg["kv_lora_rank"], rope], dim=-1)
    k_pe = k_pe.view(b, s, 1, rope).transpose(1, 2)
    kv = F.linear(rms_norm(ckv, sd[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"]),
                  sd[p + "kv_b_proj.weight"]).view(b, s, H, nope + vd).transpose(1, 2)
    k_nope, v = kv.split([nope, vd], dim=-1)
    positions = torch.arange(s)
    q_pe = apply_rope(q_pe, positions, rope, cfg["rope_theta"])
    k_pe = apply_rope(k_pe, positions, rope, cfg["rope_theta"])
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, H, s, rope)], dim=-1)
    weights = query @ key.transpose(2, 3) / math.sqrt(nope + rope)
    weights = weights.masked_fill(~mask, torch.finfo(torch.float32).min)
    out = torch.softmax(weights, dim=-1) @ v
    return F.linear(out.transpose(1, 2).reshape(b, s, H * vd), sd[p + "o_proj.weight"])


def forward(sd: Dict[str, torch.Tensor], cfg: Dict, input_ids, attention_mask):
    """``sd``: HF names (``model.`` prefixed), float32; -> [b, s, D]."""
    sd = {k: v.float() for k, v in sd.items()}
    s = input_ids.shape[1]
    eps = cfg["rms_norm_eps"]
    mask = (torch.ones(s, s, dtype=torch.bool).tril()[None, None]
            & (attention_mask[:, None, None, :] > 0))
    x = sd["model.embed_tokens.weight"][input_ids.long()]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        x = x + attention(rms_norm(x, sd[p + "input_layernorm.weight"], eps), sd, p + "self_attn.",
                          cfg, mask)
        h = rms_norm(x, sd[p + "post_attention_layernorm.weight"], eps)
        x = x + (mlp(h, sd, p + "mlp.") if i < cfg["first_k_dense_replace"]
                 else moe(h, sd, p + "mlp.", cfg))
    return rms_norm(x, sd["model.norm.weight"], eps)

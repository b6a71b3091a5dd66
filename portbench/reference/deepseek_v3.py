"""The DeepSeek-V3 text tower, plain: float32 PyTorch, TF32 off, one row at
a time at its own length (no padding, no batch), written from the published
equations (the DeepSeek-V3 technical report, arXiv:2412.19437, and the HF
``modeling_deepseek.py`` of Moonlight-16B-A3B, ``q_lora_rank`` None).

Weights are drawn here, tensor by tensor, from (seed, HF name): a generator
on the device seeded from both draws ``randn`` in float32, scaled and
rounded to bfloat16-exact values (``draw``).  The benchmark hands the
program the same draw in bfloat16 (``data/deepseek_v3.py::tree``); the
reference draws each tensor again when a layer needs it, so the card never
holds a second copy of the tower.  Magnitudes (the configuration's
``assumed``): the embedding at 1.0, every projection, router and expert at
0.02 (the published ``initializer_range``), the residual branches' output
projections at 0.02 * ``residual_scale``, the RMSNorm weights at 1 +- 0.1
and ``e_score_correction_bias`` at 0 +- ``bias_std``.  Departures:
no ``lm_head`` and no MTP layers (a text tower uses neither), as in the
program; the router reads its input rounded to bfloat16, the activation
precision the configuration states, so that the two sides select from the
same scores (with a float32 input a rounding of the activations alone would
flip a near-tie's selection), and everything else is float32.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

_MIX = 0x9E3779B97F4A7C15


def shapes(t: Dict) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """(HF name, shape) of every tensor the tower reads, from the
    configuration's ``text_tower`` (its published keys), layer by layer."""
    D, H, E = t["hidden_size"], t["num_attention_heads"], t["n_routed_experts"]
    I, S = t["moe_intermediate_size"], t["n_shared_experts"] * t["moe_intermediate_size"]
    qk = t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
    yield "model.embed_tokens.weight", (t["vocab_size"], D)
    for i in range(t["num_hidden_layers"]):
        yield from layer_shapes(t, i)
    yield "model.norm.weight", (D,)


def layer_shapes(t: Dict, i: int) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    D, H, E = t["hidden_size"], t["num_attention_heads"], t["n_routed_experts"]
    I, S = t["moe_intermediate_size"], t["n_shared_experts"] * t["moe_intermediate_size"]
    qk = t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
    p = f"model.layers.{i}."
    yield p + "input_layernorm.weight", (D,)
    yield p + "self_attn.q_proj.weight", (H * qk, D)
    yield p + "self_attn.kv_a_proj_with_mqa.weight", (t["kv_lora_rank"] + t["qk_rope_head_dim"], D)
    yield p + "self_attn.kv_a_layernorm.weight", (t["kv_lora_rank"],)
    yield p + "self_attn.kv_b_proj.weight", (H * (t["qk_nope_head_dim"] + t["v_head_dim"]),
                                             t["kv_lora_rank"])
    yield p + "self_attn.o_proj.weight", (D, H * t["v_head_dim"])
    yield p + "post_attention_layernorm.weight", (D,)
    if i < t["first_k_dense_replace"]:
        W = t["intermediate_size"]
        yield p + "mlp.gate_proj.weight", (W, D)
        yield p + "mlp.up_proj.weight", (W, D)
        yield p + "mlp.down_proj.weight", (D, W)
        return
    yield p + "mlp.gate.weight", (E, D)
    yield p + "mlp.gate.e_score_correction_bias", (E,)
    for j in range(E):
        yield p + f"mlp.experts.{j}.gate_proj.weight", (I, D)
        yield p + f"mlp.experts.{j}.up_proj.weight", (I, D)
        yield p + f"mlp.experts.{j}.down_proj.weight", (D, I)
    if S:
        yield p + "mlp.shared_experts.gate_proj.weight", (S, D)
        yield p + "mlp.shared_experts.up_proj.weight", (S, D)
        yield p + "mlp.shared_experts.down_proj.weight", (D, S)


def _scale(name: str, t: Dict) -> Tuple[float, float]:
    """(mean, std) of a tensor by the kind its name says."""
    if name.endswith("embed_tokens.weight"):
        return 0.0, 1.0
    if name.endswith("e_score_correction_bias"):
        return 0.0, float(t["bias_std"])
    if name.endswith(("norm.weight", "layernorm.weight")):
        return 1.0, 0.1
    if name.endswith(("o_proj.weight", "down_proj.weight")):
        return 0.0, 0.02 * float(t.get("residual_scale", 1.0))
    return 0.0, 0.02


def draw(seed: int, name: str, shape, t: Dict, device) -> torch.Tensor:
    """The float32 values (bfloat16-exact; the selection bias stays float32)
    of tensor ``name`` for run seed ``seed``."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * _MIX + zlib.crc32(name.encode())) % (1 << 63))
    mean, std = _scale(name, t)
    x = torch.randn(tuple(shape), generator=g, device=device).mul_(std).add_(mean)
    return x if name.endswith("e_score_correction_bias") else x.to(torch.bfloat16).float()


class Weights:
    """The tower's float32 weights for run seed ``seed``, drawn on demand."""

    def __init__(self, t: Dict, seed: int, device):
        self.t, self.seed, self.device = t, int(seed), device

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s tensors, names without the ``model.layers.{i}.`` stem."""
        stem = f"model.layers.{i}."
        return {name[len(stem):]: draw(self.seed, name, shape, self.t, self.device)
                for name, shape in layer_shapes(self.t, i)}

    def one(self, name: str, shape) -> torch.Tensor:
        return draw(self.seed, name, shape, self.t, self.device)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` [L, heads, d]: pair (2i, 2i + 1) at position p turned by p * theta^(-2i / d)."""
    L, d = x.shape[0], x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    angle = (torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * freq).float()
    cos, sin = angle.cos()[:, None], angle.sin()[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def attention(w: Dict, t: Dict, h: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Latent attention of one row: ``h`` [L, D] (normed) -> [L, D]."""
    L = h.shape[0]
    H, nope, rp, vd = (t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                       t["v_head_dim"])
    q = (h @ w["self_attn.q_proj.weight"].T).view(L, H, nope + rp)
    kv_a = h @ w["self_attn.kv_a_proj_with_mqa.weight"].T
    c_kv = rms(kv_a[:, :t["kv_lora_rank"]], w["self_attn.kv_a_layernorm.weight"], t["rms_norm_eps"])
    kv = (c_kv @ w["self_attn.kv_b_proj.weight"].T).view(L, H, nope + vd)
    theta = float(t["rope_theta"])
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k_pe = rope(kv_a[:, None, t["kv_lora_rank"]:], theta).expand(L, H, rp)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rp)
    if causal:
        scores = scores.masked_fill(~torch.ones(L, L, dtype=torch.bool, device=h.device).tril(),
                                    float("-inf"))
    ctx = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), kv[..., nope:])
    return ctx.reshape(L, H * vd) @ w["self_attn.o_proj.weight"].T


def swiglu(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ gate.T) * (h @ up.T)) @ down.T


def route(w: Dict, t: Dict, h: torch.Tensor):
    """-> (chosen [T, k], weights [T, k], margin [T]: the k-th biased score
    less the (k+1)-th, the distance of the selection from a tie)."""
    k = t["num_experts_per_tok"]
    router_in = h.to(torch.bfloat16).float()
    scores = torch.sigmoid(router_in @ w["mlp.gate.weight"].T)
    biased = scores + w["mlp.gate.e_score_correction_bias"]
    top = torch.topk(biased, k + 1, dim=-1)
    chosen = top.indices[:, :k]
    weights = scores.gather(1, chosen)
    if k > 1 and t["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return chosen, weights * t["routed_scaling_factor"], top.values[:, k - 1] - top.values[:, k]


def mlp(w: Dict, t: Dict, i: int, h: torch.Tensor):
    """The MLP of layer ``i`` over tokens ``h`` [T, D] (normed) -> (out [T, D],
    margin [T], +inf for the dense layers)."""
    if i < t["first_k_dense_replace"]:
        out = swiglu(h, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"], w["mlp.down_proj.weight"])
        return out, torch.full((h.shape[0],), float("inf"), device=h.device)
    chosen, weights, margin = route(w, t, h)
    rows = h.new_zeros(h.shape[0], chosen.shape[1], h.shape[1])  # (token, slot)
    for e in range(t["n_routed_experts"]):
        token, slot = torch.nonzero(chosen == e, as_tuple=True)
        if len(token):
            p = f"mlp.experts.{e}."
            y = swiglu(h[token], w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                       w[p + "down_proj.weight"])
            rows[token, slot] = y * weights[token, slot, None]
    out = rows.sum(1)
    if t["n_shared_experts"]:
        p = "mlp.shared_experts."
        out = out + swiglu(h, w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                           w[p + "down_proj.weight"])
    return out, margin


def pooled(weights: Weights, rows: List[torch.Tensor]) -> torch.Tensor:
    """The final RMSNorm of each row's last token, ``[n, D]``; ``rows``:
    the valid ids of each row (1-D)."""
    t = weights.t
    eps = t["rms_norm_eps"]
    embed = weights.one("model.embed_tokens.weight", (t["vocab_size"], t["hidden_size"]))
    xs = [embed[r.long()] for r in rows]
    del embed
    for i in range(t["num_hidden_layers"]):
        w = weights.layer(i)
        xs = [x + attention(w, t, rms(x, w["input_layernorm.weight"], eps)) for x in xs]
        lens = [len(x) for x in xs]
        h = rms(torch.cat(xs), w["post_attention_layernorm.weight"], eps)
        xs = list(torch.cat(xs).add(mlp(w, t, i, h)[0]).split(lens))
        del w, h
    norm = weights.one("model.norm.weight", (t["hidden_size"],))
    return torch.stack([rms(x[-1], norm, eps) for x in xs])

"""The Kimi-Linear text tower, plain: float32 PyTorch, TF32 off, one row at a
time at its own length (no padding, no batch), written from the published
equations ("Kimi Linear", arXiv:2510.26692, and the layer equations of
Kimi-Linear-48B-A3B's ``config.json``: Kimi Delta Attention in the layers
``linear_attn_config`` lists as ``kda_layers`` (1-indexed), latent attention
without positions in its ``full_attn_layers``, DeepSeek-V3's MLP and MoE).

* KDA, per token t of a row, h = RMSNorm(x): q~, k~, v~ = h W_q, h W_k, h W_v;
  q, k, v = silu(causal depthwise conv_4 of each), no bias, zeros before
  position 0; q and k L2-normalized per head with eps 1e-6 (x rsqrt(sum x^2 +
  1e-6)); f = (h W_fa) W_fb, g = -exp(A_log[head]) softplus(f + dt_bias),
  alpha = exp(g); beta = sigmoid(h W_b); the state S [d, d] a head from 0,
  token by token: S <- diag(alpha_t) S; S <- S + beta_t k_t (v_t - S^T
  k_t)^T; o_t = d^-1/2 S^T q_t; r = (h W_ga) W_gb + b_g; y = RMSNorm_d(o)
  w_norm * sigmoid(r) per head; x += y W_o.
* MLA: Moonlight's latent attention (``reference/deepseek_v3.py``) with no
  rotation of ``q_pe`` and ``k_pe``, which stay in the scores (scale 1 /
  sqrt(qk_nope + qk_rope)).
* MoE: the noaux_tc router over all ``router_experts`` (sigmoid, the
  selection bias, top ``num_experts_per_token``, weights over all k chosen
  renormalized and scaled); the configuration's ``experts_held`` alone add
  their weighted rows, plus the shared expert.  The experts this card does
  not hold add nothing, as in the program.

Weights are drawn here, tensor by tensor, from (seed, HF name), as
``reference/deepseek_v3.py`` draws them (``draw``): the embedding at 1.0,
every projection, router and expert at 0.02, the residual branches' output
projections (``o_proj``, ``down_proj``) at 0.02 * ``residual_scale``, RMSNorm
weights (``o_norm`` too) at 1 +- 0.1, the selection bias at 0 +- ``bias_std``,
the convolutions U(-0.5, 0.5), ``A_log`` = log U(1, 16), ``dt_bias`` such
that softplus(dt_bias) is log-uniform in [1e-3, 1e-1], ``g_b_proj.bias`` 0;
bfloat16-exact except ``A_log``, ``dt_bias`` and the selection bias, which the
program holds in float32.  Departures: no ``lm_head``; the router reads its
input rounded to bfloat16 (the activation precision the configuration
states), so that both sides select from the same scores.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from .deepseek_v3 import _MIX, rms, swiglu

L2_EPS = 1e-6


def _linear(t: Dict) -> Dict:
    return t["linear_attn_config"]


def is_kda(t: Dict, i: int) -> bool:
    return i + 1 in _linear(t)["kda_layers"]


def held(t: Dict) -> range:
    return range(*t["experts_held"])


def shapes(t: Dict) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """(HF name, shape) of every tensor the tower reads, layer by layer."""
    yield "model.embed_tokens.weight", (t["vocab_size"], t["hidden_size"])
    for i in range(t["num_hidden_layers"]):
        yield from layer_shapes(t, i)
    yield "model.norm.weight", (t["hidden_size"],)


def layer_shapes(t: Dict, i: int) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    D = t["hidden_size"]
    p = f"model.layers.{i}."
    yield p + "input_layernorm.weight", (D,)
    if is_kda(t, i):
        H, d = _linear(t)["num_heads"], _linear(t)["head_dim"]
        a = p + "self_attn."
        for name in ("q", "k", "v"):
            yield a + f"{name}_proj.weight", (H * d, D)
        for name in ("q", "k", "v"):
            yield a + f"{name}_conv1d.weight", (H * d, 1, _linear(t)["short_conv_kernel_size"])
        yield a + "A_log", (H,)
        yield a + "f_a_proj.weight", (d, D)
        yield a + "f_b_proj.weight", (H * d, d)
        yield a + "dt_bias", (H * d,)
        yield a + "b_proj.weight", (H, D)
        yield a + "g_a_proj.weight", (d, D)
        yield a + "g_b_proj.weight", (H * d, d)
        yield a + "g_b_proj.bias", (H * d,)
        yield a + "o_norm.weight", (d,)
        yield a + "o_proj.weight", (D, H * d)
    else:
        H = t["num_attention_heads"]
        qk = t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
        yield p + "self_attn.q_proj.weight", (H * qk, D)
        yield p + "self_attn.kv_a_proj_with_mqa.weight", (t["kv_lora_rank"] + t["qk_rope_head_dim"],
                                                          D)
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
    I, E = t["moe_intermediate_size"], t["router_experts"]
    yield p + "mlp.gate.weight", (E, D)
    yield p + "mlp.gate.e_score_correction_bias", (E,)
    for j in held(t):
        yield p + f"mlp.experts.{j}.gate_proj.weight", (I, D)
        yield p + f"mlp.experts.{j}.up_proj.weight", (I, D)
        yield p + f"mlp.experts.{j}.down_proj.weight", (D, I)
    S = t["num_shared_experts"] * I
    if S:
        yield p + "mlp.shared_experts.gate_proj.weight", (S, D)
        yield p + "mlp.shared_experts.up_proj.weight", (S, D)
        yield p + "mlp.shared_experts.down_proj.weight", (D, S)


FLOAT32 = ("e_score_correction_bias", ".A_log", ".dt_bias")  # held in float32 by the program


def draw(seed: int, name: str, shape, t: Dict, device) -> torch.Tensor:
    """The float32 values of tensor ``name`` for run seed ``seed`` (module
    docstring; bfloat16-exact but for ``FLOAT32``)."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * _MIX + zlib.crc32(name.encode())) % (1 << 63))
    shape = tuple(shape)
    if name.endswith(".A_log"):
        x = torch.rand(shape, generator=g, device=device).mul_(15.0).add_(1.0).log_()
    elif name.endswith(".dt_bias"):
        dt = torch.rand(shape, generator=g, device=device).mul_(math.log(100.0)).add_(
            math.log(1e-3)).exp_()
        x = dt + torch.log(-torch.expm1(-dt))  # softplus(x) = dt
    elif name.endswith("_conv1d.weight"):
        x = torch.rand(shape, generator=g, device=device).sub_(0.5)
    elif name.endswith("g_b_proj.bias"):
        x = torch.zeros(shape, device=device)
    else:
        x = torch.randn(shape, generator=g, device=device)
        if name.endswith("embed_tokens.weight"):
            pass
        elif name.endswith("e_score_correction_bias"):
            x.mul_(float(t["bias_std"]))
        elif name.endswith(("norm.weight", "layernorm.weight")):
            x.mul_(0.1).add_(1.0)
        elif name.endswith(("o_proj.weight", "down_proj.weight")):
            x.mul_(0.02 * float(t.get("residual_scale", 1.0)))
        else:
            x.mul_(0.02)
    return x if name.endswith(FLOAT32) else x.to(torch.bfloat16).float()


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


def scan(w: Dict, t: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         f: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The KDA scan of one row from its projections (``q``, ``k``, ``v`` before
    the convolutions and the decay's pre-activation ``f``, [L, H d]; beta's
    logits ``b`` [L, H]) -> o [L, H, d], the recurrence token by token."""
    H, d = _linear(t)["num_heads"], _linear(t)["head_dim"]
    L = q.shape[0]
    a = "self_attn."

    def conv(x, name):
        taps = w[a + name].reshape(H * d, -1)
        n = taps.shape[1]
        xp = torch.cat([x.new_zeros(n - 1, H * d), x])
        return F.silu(sum(taps[:, j] * xp[j:j + L] for j in range(n)))

    def l2(x):
        return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)

    q = l2(conv(q, "q_conv1d.weight").view(L, H, d))
    k = l2(conv(k, "k_conv1d.weight").view(L, H, d))
    v = conv(v, "v_conv1d.weight").view(L, H, d)
    g = -torch.exp(w[a + "A_log"])[:, None] * F.softplus(f + w[a + "dt_bias"]).view(L, H, d)
    beta = torch.sigmoid(b)
    S = q.new_zeros(H, d, d)
    o = q.new_zeros(L, H, d)
    for i in range(L):
        S = torch.exp(g[i])[:, :, None] * S
        u = v[i] - torch.einsum("hij,hi->hj", S, k[i])
        S = S + beta[i][:, None, None] * k[i][:, :, None] * u[:, None, :]
        o[i] = torch.einsum("hij,hi->hj", S, q[i]) * d ** -0.5
    return o


def kda(w: Dict, t: Dict, h: torch.Tensor) -> torch.Tensor:
    """Kimi Delta Attention of one row: ``h`` [L, D] (normed) -> [L, D]."""
    H, d = _linear(t)["num_heads"], _linear(t)["head_dim"]
    L = h.shape[0]
    a = "self_attn."
    o = scan(w, t, *(h @ w[a + f"{n}_proj.weight"].T for n in ("q", "k", "v")),
             (h @ w[a + "f_a_proj.weight"].T) @ w[a + "f_b_proj.weight"].T,
             h @ w[a + "b_proj.weight"].T)
    r = (h @ w[a + "g_a_proj.weight"].T) @ w[a + "g_b_proj.weight"].T + w[a + "g_b_proj.bias"]
    y = rms(o, w[a + "o_norm.weight"], t["rms_norm_eps"]) * torch.sigmoid(r).view(L, H, d)
    return y.reshape(L, H * d) @ w[a + "o_proj.weight"].T


def mla(w: Dict, t: Dict, h: torch.Tensor) -> torch.Tensor:
    """Latent attention of one row without positions: ``h`` [L, D] (normed)
    -> [L, D], causal."""
    L = h.shape[0]
    H, nope, rp, vd = (t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                       t["v_head_dim"])
    q = (h @ w["self_attn.q_proj.weight"].T).view(L, H, nope + rp)
    kv_a = h @ w["self_attn.kv_a_proj_with_mqa.weight"].T
    c_kv = rms(kv_a[:, :t["kv_lora_rank"]], w["self_attn.kv_a_layernorm.weight"], t["rms_norm_eps"])
    kv = (c_kv @ w["self_attn.kv_b_proj.weight"].T).view(L, H, nope + vd)
    k = torch.cat([kv[..., :nope], kv_a[:, None, t["kv_lora_rank"]:].expand(L, H, rp)], dim=-1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rp)
    scores = scores.masked_fill(~torch.ones(L, L, dtype=torch.bool, device=h.device).tril(),
                                float("-inf"))
    ctx = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), kv[..., nope:])
    return ctx.reshape(L, H * vd) @ w["self_attn.o_proj.weight"].T


def attention(w: Dict, t: Dict, i: int, h: torch.Tensor) -> torch.Tensor:
    return kda(w, t, h) if is_kda(t, i) else mla(w, t, h)


def route(w: Dict, t: Dict, h: torch.Tensor):
    """-> (chosen [T, k] over all ``router_experts``, weights [T, k], margin
    [T]: the k-th biased score less the (k+1)-th)."""
    k = t["num_experts_per_token"]
    scores = torch.sigmoid(h.to(torch.bfloat16).float() @ w["mlp.gate.weight"].T)
    top = torch.topk(scores + w["mlp.gate.e_score_correction_bias"], k + 1, dim=-1)
    chosen = top.indices[:, :k]
    weights = scores.gather(1, chosen)
    if k > 1 and t["moe_renormalize"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return chosen, weights * t["routed_scaling_factor"], top.values[:, k - 1] - top.values[:, k]


def mlp(w: Dict, t: Dict, i: int, h: torch.Tensor):
    """The MLP of layer ``i`` over tokens ``h`` [T, D] (normed) -> (out [T, D],
    margin [T], +inf for the dense layers): of the routed experts, the held
    ones' weighted rows."""
    if i < t["first_k_dense_replace"]:
        out = swiglu(h, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"],
                     w["mlp.down_proj.weight"])
        return out, torch.full((h.shape[0],), float("inf"), device=h.device)
    chosen, weights, margin = route(w, t, h)
    rows = h.new_zeros(h.shape[0], chosen.shape[1], h.shape[1])  # (token, slot)
    for e in held(t):
        token, slot = torch.nonzero(chosen == e, as_tuple=True)
        if len(token):
            p = f"mlp.experts.{e}."
            y = swiglu(h[token], w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                       w[p + "down_proj.weight"])
            rows[token, slot] = y * weights[token, slot, None]
    out = rows.sum(1)
    if t["num_shared_experts"]:
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
        xs = [x + attention(w, t, i, rms(x, w["input_layernorm.weight"], eps)) for x in xs]
        lens = [len(x) for x in xs]
        h = rms(torch.cat(xs), w["post_attention_layernorm.weight"], eps)
        xs = list(torch.cat(xs).add(mlp(w, t, i, h)[0]).split(lens))
        del w, h
    norm = weights.one("model.norm.weight", (t["hidden_size"],))
    return torch.stack([rms(x[-1], norm, eps) for x in xs])

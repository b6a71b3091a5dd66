"""A plain float32 reference of the Kimi-Linear text tower for the CPU tests
(the benchmark keeps a copy, ``portbench/reference/kimi_linear.py``, that
draws its weights from a seed): one row at a time at its own length, Kimi
Delta Attention token by token, latent attention without positions, the
noaux_tc router over every expert with only the held ones' rows added, plus
the shared expert.  Plain ``torch`` over an HF-named state dict; it imports
no JAX and nothing of the port.  ``t``: the configuration under its
published keys (``linear_attn_config`` nested), with ``router_experts`` the
router's width and ``experts_held`` the held range.

The layer equations, per token t of a row, h = RMSNorm(x):

* KDA: q~, k~, v~ = h W_q, h W_k, h W_v; q, k, v = silu(causal depthwise
  conv_4 of each), no bias, zeros before position 0; q and k L2-normalized
  per head (x rsqrt(sum x^2 + 1e-6)); f = (h W_fa) W_fb, g = -exp(A_log[head])
  softplus(f + dt_bias), alpha = exp(g); beta = sigmoid(h W_b); S [d, d] a
  head from 0: S <- diag(alpha_t) S; S <- S + beta_t k_t (v_t - S^T k_t)^T;
  o_t = d^-1/2 S^T q_t; r = (h W_ga) W_gb + b_g; y = RMSNorm_d(o) w_norm *
  sigmoid(r) per head; x += y W_o.
* MLA: DeepSeek-V3's latent attention, ``q_pe`` and ``k_pe`` unrotated, scale
  1 / sqrt(qk_nope + qk_rope), causal.
* MLP: a dense SwiGLU before ``first_k_dense_replace``, else the MoE.

Departures: no ``lm_head``; the router reads its input rounded to the
tower's activation dtype (``router_dtype``), so that a bf16 program and the
reference select from the same scores."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F


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
    router_in = h.to(t.get("router_dtype", torch.float32)).float()
    scores = torch.sigmoid(router_in @ w["mlp.gate.weight"].T)
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


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def swiglu(h, gate, up, down):
    return (F.silu(h @ gate.T) * (h @ up.T)) @ down.T


def forward(sd: Dict[str, torch.Tensor], t: Dict, input_ids, attention_mask) -> torch.Tensor:
    """``sd``: HF names (``model.`` prefixed); rows of right-padded ``input_ids``
    -> ``[b, s, D]`` float32 (the final RMSNorm's output at each row's valid
    positions, zeros past them)."""
    sd = {k: v.float() for k, v in sd.items()}
    eps = t["rms_norm_eps"]
    lens = [int(n) for n in attention_mask.sum(1)]
    xs = [sd["model.embed_tokens.weight"][ids[:n].long()] for ids, n in zip(input_ids, lens)]
    for i in range(t["num_hidden_layers"]):
        stem = f"model.layers.{i}."
        w = {k[len(stem):]: v for k, v in sd.items() if k.startswith(stem)}
        xs = [x + attention(w, t, i, rms(x, w["input_layernorm.weight"], eps)) for x in xs]
        h = rms(torch.cat(xs), w["post_attention_layernorm.weight"], eps)
        xs = list(torch.cat(xs).add(mlp(w, t, i, h)[0]).split(lens))
    out = torch.zeros(*input_ids.shape, t["hidden_size"])
    for r, x in enumerate(xs):
        out[r, :lens[r]] = rms(x, sd["model.norm.weight"], eps)
    return out

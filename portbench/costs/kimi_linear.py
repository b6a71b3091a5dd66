"""Kimi-Linear text-tower costs from shapes and token counts (the
configuration's published keys; ``router_experts`` the router's width,
``num_experts`` the experts held here).

``token_macs``: multiply-adds of one token through every layer outside
attention's scores and the KDA scan: the KDA layers' projections (q, k, v
and o, H d wide; the low-rank decay and output gates D -> d -> H d; beta's
H), the latent attention's projections, the dense MLP, and in each MoE layer
the router (``router_experts`` wide), the held share of the k routed experts
(k ``num_experts`` / ``router_experts`` a token) and the shared experts.

``scan_flops``: the KDA scan of one head over a row in the chunked form at
chunks of C = 64: a chunk of n tokens takes 3 n d^2 multiply-adds (the
state's three products: its read by the keys and by the queries, and its
update) and 2 n^2 d (the key-key and query-key products under the decay,
the triangular solve, and the query-key product's application), two
operations a multiply-add.

``scan_call``: one launch of the KDA kernel over a chunk of rows (a layer):
the operations above over every head, and its least bytes, the valid tokens
only: a token's pre-convolution q, k, v and gate pre-activation f (H d bf16
each) and beta's H bf16 logits read, its output (H d bf16) written:
41,024 bytes a token at 32 heads of 128.

``row_flops``: a row of L valid tokens: L ``token_macs``, causal latent
attention over each prefix (L (L + 1) / 2 query-key pairs a head, each
qk_nope + qk_rope products for the scores and v for the values) and the
scan of every KDA layer; norms, convolutions, gates and the embedding are
not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

CHUNK = 64


def _kda(t: Dict) -> Tuple[int, int, int]:
    """-> (KDA layers, heads, head size)."""
    linear = t["linear_attn_config"]
    return len(linear["kda_layers"]), linear["num_heads"], linear["head_dim"]


def token_macs(t: Dict) -> float:
    D, I = t["hidden_size"], t["moe_intermediate_size"]
    n_kda, H, d = _kda(t)
    kda = 4 * D * H * d + 2 * (D * d + d * H * d) + D * H
    A = t["num_attention_heads"]
    qk = t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
    mla = (D * A * qk + D * (t["kv_lora_rank"] + t["qk_rope_head_dim"])
           + t["kv_lora_rank"] * A * (t["qk_nope_head_dim"] + t["v_head_dim"])
           + A * t["v_head_dim"] * D)
    held = t["num_experts_per_token"] * t["num_experts"] / t["router_experts"]
    moe = D * t["router_experts"] + (held + t["num_shared_experts"]) * 3 * D * I
    layers, first = t["num_hidden_layers"], t["first_k_dense_replace"]
    return (n_kda * kda + (layers - n_kda) * mla + first * 3 * D * t["intermediate_size"]
            + (layers - first) * moe)


def scan_flops(length: int, heads: int, head_dim: int) -> float:
    """Operations of the chunked scan over one row of ``length`` valid tokens."""
    full, rest = divmod(int(length), CHUNK)
    macs = sum(3 * n * head_dim ** 2 + 2 * n * n * head_dim for n in [CHUNK] * full + [rest] if n)
    return 2.0 * heads * macs


def scan_call(lengths: Sequence[int], t: Dict) -> Tuple[float, float]:
    """-> (operations, least bytes) of one KDA kernel launch over rows of
    these valid lengths (module docstring)."""
    _n, H, d = _kda(t)
    ops = sum(scan_flops(n, H, d) for n in lengths)
    nbytes = 2.0 * sum(int(n) for n in lengths) * (5 * H * d + H)
    return ops, nbytes


def row_flops(t: Dict, length: int) -> float:
    """Operations of one row of ``length`` valid tokens (module docstring)."""
    n_kda, H, d = _kda(t)
    pairs = length * (length + 1) // 2
    per_pair = t["num_attention_heads"] * (t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
                                           + t["v_head_dim"])
    mla_layers = t["num_hidden_layers"] - n_kda
    return (2.0 * (length * token_macs(t) + mla_layers * pairs * per_pair)
            + n_kda * scan_flops(length, H, d))


def bank_flops(t: Dict, lengths: Sequence[int]) -> float:
    return float(sum(row_flops(t, int(n)) for n in lengths))

"""DeepSeek-V3 text-tower costs from shapes and token counts.

``row_flops``: the model operations of one row of ``L`` valid tokens, two a
multiply-add: every projection, the router, the dense MLP, the k routed and
the shared experts per token, and causal attention over each valid prefix
(position p attends to p + 1 keys: ``L (L + 1) / 2`` query-key pairs a head,
each ``qk_nope + qk_rope`` products for the scores and ``v_head_dim`` for
the values).  Norms, RoPE, softmax and the embedding lookup are not counted.

``expert_call``: one call of the grouped expert kernel (its gate|up and its
down launch) over a layer's chunk, from the tokens each expert got:
operations ``2 rows D 3 I``; minimal bytes: the chunk's activations once,
each row's token index, the weights of every expert that got a token, the
SwiGLU rows written by the first launch and read by the second, each row's
weight and place, and the weighted rows written.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def token_macs(t: Dict) -> int:
    """Multiply-adds of one token through every layer, attention's scores
    and values left out."""
    D, H, I = t["hidden_size"], t["num_attention_heads"], t["moe_intermediate_size"]
    qk = t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
    attn = (D * H * qk + D * (t["kv_lora_rank"] + t["qk_rope_head_dim"])
            + t["kv_lora_rank"] * H * (t["qk_nope_head_dim"] + t["v_head_dim"])
            + H * t["v_head_dim"] * D)
    dense = 3 * D * t["intermediate_size"]
    moe = D * t["n_routed_experts"] + (t["num_experts_per_tok"] + t["n_shared_experts"]) * 3 * D * I
    layers, first = t["num_hidden_layers"], t["first_k_dense_replace"]
    return layers * attn + first * dense + (layers - first) * moe


def row_flops(t: Dict, length: int) -> float:
    """Operations of one row of ``length`` valid tokens (module docstring)."""
    pairs = length * (length + 1) // 2
    per_pair = t["num_attention_heads"] * (t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
                                           + t["v_head_dim"])
    return 2.0 * (length * token_macs(t) + t["num_hidden_layers"] * pairs * per_pair)


def bank_flops(t: Dict, lengths: Sequence[int]) -> float:
    return float(sum(row_flops(t, int(n)) for n in lengths))


def expert_call(counts: Sequence[int], d_model: int, width: int, k: int) -> Tuple[float, float]:
    """-> (operations, minimal bytes) of one grouped-kernel call (module docstring)."""
    rows = int(sum(counts))
    active = sum(1 for c in counts if c > 0)
    ops = 2.0 * rows * d_model * 3 * width
    tokens = rows // k
    nbytes = (tokens * d_model * 2 + rows * 4 + active * 3 * width * d_model * 2
              + 2 * rows * width * 2 + rows * 8 + rows * d_model * 2)
    return ops, float(nbytes)

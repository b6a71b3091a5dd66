"""The RMSNorm kernel's share of its roofline, in percent: the least time the
card needs for every call of the traced sweeps over the device time of
``rms_norm_kernel`` in the trace.  The kernel is bound by bytes, so a call's
least time is its least bytes at the HBM peak, counting only the valid
tokens (the traced sweeps' ``lengths``): each call reads a token's bf16 row
and writes its output (bf16, float32 for the final norm), the gated call
also reads its bf16 gate; weights are not counted.  A bank chunk's calls,
from the tower's configuration: two at ``hidden_size`` a layer, one at
``kv_lora_rank`` a latent-attention layer (every layer of a DeepSeek-V3
tower, the ``full_attn_layers`` of a Kimi-Linear one), one gated at
``num_heads`` x ``head_dim`` a KDA layer, and the final.  Padding the kernel
computes counts as distance from the roof.  Nothing without the kernel in
the trace."""

import re

KERNEL = re.compile(r"\brms_norm_kernel\b")


def token_bytes(tower) -> float:
    """The least bytes one valid token moves through every norm of a forward."""
    D, layers, latent = tower["hidden_size"], tower["num_hidden_layers"], tower["kv_lora_rank"]
    linear = tower.get("linear_attn_config")
    if linear:
        mla, gated = len(linear["full_attn_layers"]), len(linear["kda_layers"])
        heads = linear["num_heads"] * linear["head_dim"]
    else:
        mla, gated, heads = layers, 0, 0
    return (2 * layers * (2 * D + 2 * D) + mla * (2 * latent + 2 * latent)
            + gated * (2 * heads + 2 * heads + 2 * heads) + (2 * D + 4 * D))


def value(kernel_s, lengths, tower, peaks):
    seconds = sum(s for name, s in kernel_s.items() if KERNEL.search(name))
    if seconds <= 0 or not lengths:
        return None
    bound = sum(lengths) * token_bytes(tower) / peaks["hbm_bytes"]
    return 100.0 * bound / seconds


def read(r):
    trace, peaks = r.get("trace"), r.get("peaks")
    if not trace or not peaks or not r.get("lengths") or "tower" not in r:
        return None
    return value(trace["kernel_s"], [int(n) for n in r["lengths"]], r["tower"], peaks)

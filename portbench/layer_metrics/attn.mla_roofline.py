"""The causal latent-attention kernel's share of its roofline, in percent:
the least time the card needs for every launch of the traced sweeps over the
device time of ``mla_attention_kernel`` in the trace.  A launch is one layer
of one bank chunk (256 rows in sweep order, the traced sweeps' ``lengths``);
its least time is the larger of its operations at the bf16 tensor-core peak
and its minimal bytes at the HBM peak, counting only the chunk's valid
tokens: operations 2 H L (L + 1) / 2 (nope + rope + v) a row of L valid
tokens (each position attends to its prefix), bytes a valid token's q (H
(nope + rope)), k_nope and v (H (nope + v)) and shared k_pe (rope) read and
its context (H v) written, all bf16.  Padding the kernel computes counts as
distance from the roof.  Nothing without the kernel in the trace."""

import re

KERNEL = re.compile(r"\bmla_attention_kernel\b")
CHUNK = 256  # the rows of a chunk of the trainer's bank encode


def launch_bound(lengths, tower, peaks) -> float:
    """The least seconds of one launch over rows of these valid lengths."""
    H, nope, rope, v = (tower["num_attention_heads"], tower["qk_nope_head_dim"],
                        tower["qk_rope_head_dim"], tower["v_head_dim"])
    ops = sum(2.0 * H * (n * (n + 1) // 2) * (nope + rope + v) for n in lengths)
    nbytes = 2.0 * sum(lengths) * (H * (nope + rope) + H * (nope + v) + rope + H * v)
    return max(ops / peaks["bf16"], nbytes / peaks["hbm_bytes"])


def value(kernel_s, lengths, tower, peaks):
    seconds = sum(s for name, s in kernel_s.items() if KERNEL.search(name))
    if seconds <= 0 or not lengths:
        return None
    chunks = [lengths[i:i + CHUNK] for i in range(0, len(lengths), CHUNK)]
    bound = tower["num_hidden_layers"] * sum(launch_bound(c, tower, peaks) for c in chunks)
    return 100.0 * bound / seconds


def read(r):
    trace, peaks = r.get("trace"), r.get("peaks")
    if not trace or not peaks or not r.get("lengths") or "tower" not in r:
        return None
    return value(trace["kernel_s"], [int(n) for n in r["lengths"]], r["tower"], peaks)

"""The grouped expert kernel's share of its roofline in the Kimi-Linear
bank, in percent: the least time the card needs for every call of the
traced sweeps (each the larger of its operations at the bf16 tensor-core
peak and its minimal bytes at the HBM peak, ``costs/deepseek_v3.py::
expert_call``, from the rows each held expert got in that layer and chunk:
the port's ``moe.tokens_per_expert`` counters, which carry the held range)
over the device time of the kernel's two launches in the trace
(``grouped_gemm_kernel``).  The kernel is the Moonlight bank's, here at
2304 -> 1024 over 128 of 256 experts.  Nothing when the program's launch
count disagrees with the MoE layers times the traced chunks, or from a port
without the counters."""

import re

from portbench.costs.deepseek_v3 import expert_call

KERNEL = re.compile(r"\bgrouped_gemm_kernel\b")


def value(records, kernel_s, launches, tower, peaks):
    counts = [r["attrs"]["counts"] for r in records
              if r["name"] == "moe.tokens_per_expert" and "held" in r["attrs"]]
    moe_layers = tower["num_hidden_layers"] - tower["first_k_dense_replace"]
    seconds = sum(s for name, s in kernel_s.items() if KERNEL.search(name))
    if not counts or launches != moe_layers * len(counts) or seconds <= 0:
        return None
    bound = 0.0
    for chunk in counts:
        for layer in chunk:
            ops, nbytes = expert_call(layer, tower["hidden_size"], tower["moe_intermediate_size"],
                                      tower["num_experts_per_token"])
            bound += max(ops / peaks["bf16"], nbytes / peaks["hbm_bytes"])
    return 100.0 * bound / seconds


def read(r):
    trace, peaks = r.get("trace"), r.get("peaks")
    if not trace or not peaks or "launches" not in r:
        return None
    try:
        from mmgclip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return value(spans(), trace["kernel_s"], r["launches"], r["tower"], peaks)

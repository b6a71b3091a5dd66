"""The fused ConvNeXt block's share of its roofline, in percent: the least
time the card needs for every block launch of the traced passes (each
launch the larger of its operations at the bf16 tensor-core peak and its
minimal bytes at the HBM peak, ``costs/convnext.py``) over the device time
of the block's two kernels in the trace (``dw_kernel`` and
``ln_mlp_kernel``).  Nothing is read when the program's launch counter
disagrees with the launches the shapes imply."""

import re

from portbench.costs.convnext import tower_block_calls

KERNELS = re.compile(r"\b(dw_kernel|ln_mlp_kernel)\b")


def read(r):
    trace, peaks = r.get("trace"), r.get("peaks")
    if not trace or not peaks or not r.get("pass_counts"):
        return None
    seconds = sum(s for name, s in trace["kernel_s"].items() if KERNELS.search(name))
    if seconds <= 0:
        return None
    h, w = r["image_hw"]
    batches = sum(-(-count // r["batch_size"]) for count in r["pass_counts"])
    if r["block_launches"] != batches * sum(r["depths"]):
        return None
    bound = 0.0
    for count in r["pass_counts"]:
        for start in range(0, count, r["batch_size"]):
            n = min(r["batch_size"], count - start)
            for ops, nbytes in tower_block_calls(n, h, w, r["depths"], r["dims"]):
                bound += max(ops / peaks["bf16"], nbytes / peaks["hbm_bytes"])
    return 100.0 * bound / seconds

"""The KDA scan kernel's share of its roofline, in percent: the least time
the card needs for every launch of the traced sweeps over the device time of
``kda_kernel`` in the trace.  A launch is one KDA layer of one bank chunk
(256 rows in sweep order, the traced sweeps' ``lengths``); its least time is
the larger of its operations at the bf16 tensor-core peak (the chunked form
at chunks of 64) and its least bytes at the HBM peak, counting only the
chunk's valid tokens (``costs/kimi_linear.py::scan_call``).  Padding the
kernel computes counts as distance from the roof.  Nothing without the
kernel in the trace, or when the program's KDA launch count disagrees with
the KDA layers times the traced chunks."""

import re

from portbench.costs.kimi_linear import scan_call

KERNEL = re.compile(r"\bkda_kernel\b")
CHUNK = 256  # the rows of a chunk of the trainer's bank encode


def value(kernel_s, lengths, launches, tower, peaks):
    seconds = sum(s for name, s in kernel_s.items() if KERNEL.search(name))
    chunks = [lengths[i:i + CHUNK] for i in range(0, len(lengths), CHUNK)]
    layers = len(tower["linear_attn_config"]["kda_layers"])
    if seconds <= 0 or not chunks or launches != layers * len(chunks):
        return None
    bound = 0.0
    for chunk in chunks:
        ops, nbytes = scan_call(chunk, tower)
        bound += max(ops / peaks["bf16"], nbytes / peaks["hbm_bytes"])
    return 100.0 * layers * bound / seconds


def read(r):
    trace, peaks = r.get("trace"), r.get("peaks")
    if not trace or not peaks or not r.get("lengths") or "kda_launches" not in r:
        return None
    return value(trace["kernel_s"], [int(n) for n in r["lengths"]], r["kda_launches"], r["tower"],
                 peaks)

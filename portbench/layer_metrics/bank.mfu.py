"""The report bank's model FLOPs rate over the card's bf16 peak, in percent:
the operations of the traced sweeps' valid tokens, causal attention over
each valid prefix (``costs/deepseek_v3.py::bank_flops``; padding computed
but not counted), over those sweeps' seconds on the host clock (bank and
heads' epoch; each sweep ends in a synchronize)."""

from portbench.costs.deepseek_v3 import bank_flops


def read(r):
    peaks = r.get("peaks")
    if not peaks or not r.get("seconds") or not r.get("lengths"):
        return None
    return 100.0 * bank_flops(r["tower"], r["lengths"]) / r["seconds"] / peaks["bf16"]

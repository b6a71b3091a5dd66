"""The Kimi-Linear report bank's model FLOPs rate over the card's bf16 peak,
in percent: the operations of the traced sweeps' valid tokens
(``costs/kimi_linear.py::bank_flops``: causal latent attention over each
valid prefix, the held share of the routed experts, the KDA scan in its
chunked form; padding computed but not counted) over those sweeps' seconds
on the host clock (bank and heads' epoch; each sweep ends in a
synchronize)."""

from portbench.costs.kimi_linear import bank_flops


def read(r):
    peaks = r.get("peaks")
    if not peaks or not r.get("seconds") or not r.get("lengths") or "tower" not in r:
        return None
    return 100.0 * bank_flops(r["tower"], r["lengths"]) / r["seconds"] / peaks["bf16"]

"""The feature store's model FLOPs rate over the card's bf16 peak, in
percent: ConvNeXt's operations per image from shapes
(``costs/convnext.py::image_flops``) times the traced passes' images per
second."""

from portbench.costs.convnext import image_flops


def read(r):
    peaks = r.get("peaks")
    if not peaks or not r.get("passes_s"):
        return None
    h, w = r["image_hw"]
    rate = r["images"] / r["passes_s"]
    return 100.0 * image_flops(h, w, r["in_channels"]) * rate / peaks["bf16"]

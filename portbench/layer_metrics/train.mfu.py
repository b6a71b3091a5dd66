"""The training step's model FLOPs rate over the card's peak in the
precision the convolutions ran in (TF32 when ``cudnn.allow_tf32`` was on,
else float32), in percent: the operations per sample from shapes
(``costs/resnet.py::train_flops_per_sample``) times the traced epochs'
samples per second."""

from portbench.costs.resnet import train_flops_per_sample


def read(r):
    peaks = r.get("peaks")
    if not peaks or not r.get("seconds"):
        return None
    flops = train_flops_per_sample(r["batch_size"], r["feature_dim"], r["stage_sizes"],
                                   r["text_dim"], r["projection_dim"])
    peak = peaks["tf32"] if r["tf32"] else peaks["fp32"]
    return 100.0 * flops * r["samples"] / r["seconds"] / peak

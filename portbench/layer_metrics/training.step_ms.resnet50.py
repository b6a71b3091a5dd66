"""Device milliseconds per training step: the trainer's CUDA-event time of
the traced epochs (``timings["epoch_device_ms"]``) over their steps
(``timings["epoch_steps"]``)."""


def read(r):
    steps = sum(r.get("epoch_steps") or [])
    if not steps:
        return None
    return sum(r["epoch_device_ms"]) / steps

"""The KDA layers' share of the bank's device time, in percent: the
``kda.layer`` intervals (input norm to ``o_proj``, CUDA events of every KDA
layer and chunk of the traced sweeps) over the ``bank.device`` intervals
(each bank chunk's device time), both the port's tracer.  Nothing without
such spans, or from a port without the tracer."""


def value(records):
    layers = sum(r["end_ns"] - r["start_ns"] for r in records if r["name"] == "kda.layer")
    bank = sum(r["end_ns"] - r["start_ns"] for r in records if r["name"] == "bank.device")
    if layers <= 0 or bank <= 0:
        return None
    return 100.0 * layers / bank


def read(r):
    try:
        from mmgclip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return value(spans())

"""The routing's share of the MoE layers' device time, in percent: the
``moe.route`` intervals (gate, top-k, sort, offsets) over those and the
``moe.experts`` intervals (grouped kernel, combine, shared experts), CUDA
events of every MoE layer and chunk of the traced sweeps (the port's
tracer).  Nothing without such spans, or from a port without the tracer."""


def value(records):
    route = sum(r["end_ns"] - r["start_ns"] for r in records if r["name"] == "moe.route")
    experts = sum(r["end_ns"] - r["start_ns"] for r in records if r["name"] == "moe.experts")
    if route + experts <= 0:
        return None
    return 100.0 * route / (route + experts)


def read(r):
    try:
        from mmgclip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return value(spans())

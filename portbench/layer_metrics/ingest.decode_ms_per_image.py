"""The PNG decoder's own milliseconds per image: the summed ``encode.decode``
spans of the traced passes (one per image, on the decode threads) over
their count, apart from threading.  Read from the port's own spans
(``mmgclip_tpu_torch.utils.profiling.spans()``), recorded only under the
profiler.  Nothing without an ``encode.pass`` span, or from a port without
the tracer."""


def value(records):
    passes = {r["id"] for r in records if r["name"] == "encode.pass"}
    decodes = [r["end_ns"] - r["start_ns"] for r in records
               if r["name"] == "encode.decode" and r["parent"] in passes]
    if not decodes:
        return None
    return sum(decodes) / len(decodes) / 1e6


def read(r):
    try:
        from mmgclip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return value(spans())

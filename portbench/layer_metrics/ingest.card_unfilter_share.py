"""Share of the traced passes' PNG decodes whose rows the card unfiltered,
in percent: the ``encode.decode`` spans (one per image, on the decode
threads) marked ``unfilter: "card"`` over all of them.  Read from the port's
own spans (``mmgclip_tpu_torch.utils.profiling.spans()``), recorded only
under the profiler.  Nothing without an ``encode.pass`` span, from a port
without the tracer, or from one whose decode spans carry no ``unfilter``
mark."""


def value(records):
    passes = {r["id"] for r in records if r["name"] == "encode.pass"}
    decodes = [r for r in records if r["name"] == "encode.decode" and r["parent"] in passes]
    if not any("unfilter" in r["attrs"] for r in decodes):
        return None
    return 100.0 * sum(r["attrs"].get("unfilter") == "card" for r in decodes) / len(decodes)


def read(r):
    try:
        from mmgclip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return value(spans())

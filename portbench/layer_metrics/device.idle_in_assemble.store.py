"""Share of the traced passes' seconds in which the device had no
``encode.device`` interval open while ``extract()``'s main thread assembled
a batch (``encode.assemble``: stack, pad, canvas or host prepool, pinning),
in percent.  Read from the port's own spans
(``mmgclip_tpu_torch.utils.profiling.spans()``), which it records only under
the profiler, so only in the traced passes; the denominator is the seconds
of their ``encode.pass`` spans.  Nothing without an ``encode.pass``
span, or from a port without the tracer."""

SPAN = "encode.assemble"


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _uncovered(intervals, cover):
    """Length of the union of ``intervals`` outside the union of ``cover``."""
    total = 0
    cover = _union(cover)
    for start, end in _union(intervals):
        total += end - start
        for c0, c1 in cover:
            total -= max(0, min(end, c1) - max(start, c0))
    return total


def value(records):
    passes = {r["id"]: r for r in records if r["name"] == "encode.pass"}
    seconds = sum(r["end_ns"] - r["start_ns"] for r in passes.values())
    if seconds <= 0:
        return None
    mine = [r for r in records if r["parent"] in passes]
    device = [(r["start_ns"], r["end_ns"]) for r in mine if r["name"] == "encode.device"]
    inside = [(r["start_ns"], r["end_ns"]) for r in mine if r["name"] == SPAN]
    return 100.0 * _uncovered(inside, device) / seconds


def read(r):
    try:
        from mmgclip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return value(spans())

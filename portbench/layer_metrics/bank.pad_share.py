"""Padding's share of the tokens the bank encode computed, in percent:
``computed_tokens`` less ``valid_tokens`` over ``computed_tokens``, summed
over the traced sweeps' ``bank.chunk`` spans (the port's tracer, recording
only under the profiler).  Nothing without such a span, or from a port
without the tracer."""


def value(records):
    chunks = [r["attrs"] for r in records if r["name"] == "bank.chunk"]
    computed = sum(a["computed_tokens"] for a in chunks)
    if computed <= 0:
        return None
    return 100.0 * (computed - sum(a["valid_tokens"] for a in chunks)) / computed


def read(r):
    try:
        from mmgclip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return value(spans())

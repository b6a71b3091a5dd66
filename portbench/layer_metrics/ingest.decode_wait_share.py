"""Share of the traced passes' wall time that ``extract()``'s main thread
spent waiting for PNG decodes (``_Encoder.timings["decode_wait_s"]``,
summed over the traced passes), in percent."""


def read(r):
    if not r.get("passes_s"):
        return None
    return 100.0 * r["decode_wait_s"] / r["passes_s"]

"""The device's idle share of the traced sweeps, in percent: the window less
the union of its kernel, copy and set intervals, over the window."""


def read(r):
    trace = r.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (trace["window_s"] - trace["busy_s"]) / trace["window_s"]

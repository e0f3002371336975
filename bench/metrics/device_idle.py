"""Share of the profiled slice (a few seconds of serving, or training's
profiled steps, right after the window) in which no device operation ran:
1 - the union of the kernels' intervals over the slice."""


def read(trace):
    prof = trace.get("profile")
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

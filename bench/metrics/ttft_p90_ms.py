"""90th percentile of the traced window's times to first token: the
reader of ``ttft_p90_ms.<split>``, where the tail is a per-layer reading
(``.hostpaced``: a cell whose card is idle most of the window)."""
from bench import measure


def read(trace):
    xs = trace.get("ttft_ms")
    return measure.percentile(xs, 90) if xs else None

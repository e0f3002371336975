"""95th percentile of the traced window's gaps between tokens: the reader
of ``itl_p95_ms.<split>``, where the tail is a per-layer reading
(``.hostpaced``: a cell whose card is idle most of the window)."""
from bench import measure


def read(trace):
    xs = trace.get("itl_ms")
    return measure.percentile(xs, 95) if xs else None

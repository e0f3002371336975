"""Device time of the kernels launched inside ``ops.moe_dispatch_combine``
during prefills, over the device time of the kernels launched inside the
prefills, from the profiled slice of the window."""


def read(trace):
    ranges = (trace.get("profile") or {}).get("ranges") or {}
    prefills = ranges.get("prefill") or []
    total = sum(us for _, _, us in prefills)
    if not total:
        return None
    inside = sum(us for s, e, us in ranges.get("moe_dispatch", ())
                 if any(ps <= s and e <= pe for ps, pe, _ in prefills))
    if not inside:
        return None
    return 100.0 * inside / total

"""``flash_attention``'s least time (``roofline.flash_bound_ms`` of each
call's shapes) over the time CUDA events put around each call, summed over
the window's calls."""
from bench import roofline


def read(trace):
    calls = trace.get("flash")
    if not calls:
        return None
    bound = sum(roofline.flash_bound_ms(*shape) for _, *shape in calls)
    return 100.0 * bound / sum(ms for ms, *_ in calls)

"""The window's prefills as a share of the card's bf16 peak: their model
FLOPs (``roofline.prefill_flops``) over their synchronised time."""
from bench import roofline


def read(trace):
    calls = trace.get("prefill")
    if not calls:
        return None
    flops = sum(roofline.prefill_flops(trace["cfg"], s) for _, s in calls)
    secs = sum(ms for ms, _ in calls) / 1e3
    return 100.0 * flops / secs / roofline.PEAK_FLOPS["bfloat16"]

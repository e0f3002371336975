"""The window's training steps as a share of the card's bf16 peak:
``roofline.train_flops_per_token`` times the tokens, over the steps'
time."""
from bench import roofline


def read(trace):
    steps = trace.get("step_s")
    if not steps:
        return None
    flops = roofline.train_flops_per_token(trace["cfg"], trace["seq_len"]) \
        * trace["tokens_per_step"] * len(steps)
    return 100.0 * flops / sum(steps) / roofline.PEAK_FLOPS["bfloat16"]

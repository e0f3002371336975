"""Mean synchronised time of ``launch.train.loss_and_grads`` (the loss,
remat, fused cross-entropy and chunked attention backward) over the
window's steps, host clock."""


def read(trace):
    calls = trace.get("loss_grads_ms")
    if not calls:
        return None
    return sum(calls) / len(calls)

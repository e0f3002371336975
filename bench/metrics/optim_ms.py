"""Mean synchronised time of ``optim.adamw.apply`` over the window's
steps, host clock."""


def read(trace):
    calls = trace.get("optim_ms")
    if not calls:
        return None
    return sum(calls) / len(calls)

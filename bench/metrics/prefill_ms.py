"""Mean synchronised time of the window's prefills (``Zoo.prefill``, one
prompt at batch 1), host clock."""


def read(trace):
    calls = trace.get("prefill")
    if not calls:
        return None
    return sum(ms for ms, _ in calls) / len(calls)

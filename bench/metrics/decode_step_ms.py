"""Mean synchronised time of the window's decode steps
(``Zoo.decode_step`` over every slot), host clock."""


def read(trace):
    calls = trace.get("decode_ms")
    if not calls:
        return None
    return sum(calls) / len(calls)

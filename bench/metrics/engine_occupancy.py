"""Mean live slots of the window's decode steps over the engine's slots,
from ``DecodeEngine.occupancy`` (what ``stats()["mean_occupancy"]``
averages), read over the window alone."""


def read(trace):
    occ = trace.get("occupancy")
    if not occ:
        return None
    return 100.0 * sum(occ) / len(occ) / trace["slots"]

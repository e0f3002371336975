"""The resident loop on search, one of the two Table III apps with the most
ticks, on ``TorchBackend("cpu")`` against the numpy oracle: a single
request, and a fused batch of 3 with the replicated windowed triangle —
the checks of ``test_torch_resident.py``, in a file of their own so that
the suite's workers spread them."""
from test_torch_resident import check_batch, check_single


def test_resident_single_matches_oracle():
    check_single("search")


def test_resident_batch_matches_oracle():
    check_batch("search")

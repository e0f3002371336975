"""The port's hand-written CUDA kernels against their plain torch versions,
on the card: ``python -m pytest -q tests/test_torch_cuda.py``.

These tests import neither jax nor the JAX package, so they run on a
machine with only the port's dependencies.  Without a card they skip: the
kernels have no CPU mode.  Outputs are int32, so equality is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels import stream_compact as tsc

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
REDUCE_OPS = tsr.OPS


def _window(rng, n, max_bar=3):
    kinds = rng.choice([0, 0, 0, 1, 2, max_bar], size=n).astype(np.int64)
    vals = rng.integers(I32_MIN, I32_MAX, size=n).astype(np.int64)
    return kinds, vals


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_stream_compact_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    for n in (0, 1, 127, 128, 129, 512, 1025, 70000):
        for d in (1, 3, 5):
            mask = torch.from_numpy(
                (rng.random(n) < 0.4).astype(np.int32)).to(cuda_device)
            vals = torch.from_numpy(rng.integers(
                I32_MIN, I32_MAX, (n, d)).astype(np.int32)).to(cuda_device)
            before = tsc.stream_compact.launches
            out, cnt = tsc.stream_compact(mask, vals)
            assert tsc.stream_compact.launches == before + 1
            want, wcnt = tsc.stream_compact_plain(mask, vals)
            assert int(cnt) == int(wcnt) and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", REDUCE_OPS)
def test_cuda_segment_reduce_matches_plain(cuda_device, op):
    rng = np.random.default_rng(12)
    for n in (0, 1, 127, 128, 129, 512, 5000):
        kinds, vals = _window(rng, n)
        k = torch.from_numpy(kinds.astype(np.int32)).to(cuda_device)
        v = torch.from_numpy(vals.astype(np.int32)).to(cuda_device)
        for go, acc in ((True, 5), (False, 0), (False, -9)):
            for vv in (v, None):
                before = tsr.segment_reduce.launches
                got = tsr.segment_reduce(k, vv, 0, op, acc, go)
                assert tsr.segment_reduce.launches == before + 1
                want = tsr.segment_reduce_plain(k, vv, 0, op, acc, go)
                m = int(want[2])
                assert int(got[2]) == m
                assert torch.equal(got[3], want[3])
                assert torch.equal(got[0][:m], want[0][:m])
                assert torch.equal(got[1][:m], want[1][:m])


@pytest.mark.cuda
def test_cuda_torch_backend_runs_an_app_on_the_card(cuda_device):
    """One app end to end on ``TorchBackend()`` (CUDA by default) against
    the port's numpy oracle, through both kernels."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.backend import TorchBackend
    app = ALL_APPS["strlen"]()
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    want = lowered.compile("numpy").execute(dict(app.dram_init), app.params)
    before = (tsc.stream_compact.launches, tsr.segment_reduce.launches)
    got = lowered.compile(TorchBackend()).execute(dict(app.dram_init),
                                                  app.params)
    assert got.report.backend == "torch[cuda]"
    assert tsc.stream_compact.launches > before[0]
    assert tsr.segment_reduce.launches > before[1]
    for arr in want.dram:
        np.testing.assert_array_equal(got.dram[arr], want.dram[arr])
    assert got.vm.stats == want.vm.stats

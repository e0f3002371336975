"""Test-suite bootstrap: collect cleanly when optional deps are missing.

``hypothesis`` is optional. Several modules import it at top level
(``from hypothesis import given, settings, strategies as st``); without this
guard the whole suite dies at collection with ModuleNotFoundError. When the
real package is absent we install a minimal shim: property tests decorated
with ``@given(...)`` collect and *skip* with a clear reason, while the
deterministic tests in the same modules run normally.
"""
from __future__ import annotations

import sys
import types

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def jax_backend():
    """One shared JaxBackend (and jit cache) for every suite that crosses
    the kernel route — backends are stateless (DESIGN.md §3)."""
    from repro.core.backend import JaxBackend
    return JaxBackend()


try:
    import hypothesis  # noqa: F401  (real package wins when installed)
except ModuleNotFoundError:
    import pytest

    def _given(*_args, **_kwargs):
        def deco(fn):
            def skipper():
                pytest.skip("hypothesis not installed (property test)")
            skipper.__name__ = getattr(fn, "__name__", "hypothesis_test")
            skipper.__doc__ = getattr(fn, "__doc__", None)
            return skipper
        return deco

    def _settings(*_args, **_kwargs):
        def deco(fn):
            return fn
        return deco

    class _Anything:
        """Stands in for strategies / HealthCheck / profiles: any attribute
        access or call returns another _Anything, so strategy-building
        expressions evaluated at decoration time never fail."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    _mod = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _Anything()   # PEP 562
    _mod.given = _given
    _mod.settings = _settings
    _mod.assume = lambda *a, **k: True
    _mod.note = lambda *a, **k: None
    _mod.HealthCheck = _Anything()
    _mod.strategies = _st
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _st

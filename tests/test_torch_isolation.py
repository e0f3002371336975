"""The PyTorch port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py`` or ``tools/torch_serve_bench.py``) imports jax or the
JAX package, ``TorchBackend()`` never falls back to the CPU, and the
program crosses from the reference to the port as its post-pass IR
text."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.apps import ALL_APPS as REF_APPS
from repro.core import lowering as ref_lowering
from repro.core.compiler import compile_program as ref_compile
from repro_torch.core import lowering, textio
from repro_torch.core.backend import TorchBackend, make_backend

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax_or_reference():
    """Import every module of the port, ``chip_smoke.py`` and
    ``tools/torch_serve_bench.py`` with ``jax``, ``repro`` and
    ``ml_dtypes`` made unimportable."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
            sys.modules[name] = None
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for m in mods:
            importlib.import_module(m)
        for name, path in (("chip_smoke", {str(ROOT / "chip_smoke.py")!r}),
                           ("torch_serve_bench",
                            {str(ROOT / "tools" / "torch_serve_bench.py")!r})):
            spec = importlib.util.spec_from_file_location(name, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(k for k, v in sys.modules.items() if v is not None
                        and (k.split(".")[0] in ("jax", "jaxlib", "repro",
                                                  "ml_dtypes")))
        assert not leaked, leaked
        print(" ".join(mods))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = out.stdout.split()
    assert len(walked) >= 30                      # every module was walked
    for mod in ("models.rglru", "kernels.rg_lru", "models.ssm",
                "kernels.ssm_scan", "models.moe", "kernels.moe_dispatch",
                "kernels.hash_probe", "serve.engine", "launch.serve",
                "core.device_vm", "kernels.device_loop", "core.primitives",
                "serve.async_engine", "distributed.fault_tolerance",
                "checkpoint.ckpt", "models.encdec", "models.vlm",
                "serve.traffic", "kernels.graph_count", "optim.adamw",
                "optim.compression", "data.pipeline", "launch.train",
                "distributed.sharding", "launch.mesh", "launch.dryrun"):
        assert f"repro_torch.{mod}" in walked


def test_dryrun_runs_without_jax_or_reference(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one cell and both
    production meshes with ``jax`` and ``repro`` made unimportable: its
    fake process groups, meshes, shardings and meta trace need neither."""
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
            sys.modules[name] = None
        sys.argv = ["dryrun", "--arch", "qwen2-0.5b", "--shape",
                    "decode_32k", "--mesh", "both", "--outdir",
                    {str(tmp_path)!r}]
        runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
        leaked = sorted(k for k, v in sys.modules.items() if v is not None
                        and k.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not leaked, leaked
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dry-run complete" in out.stdout
    for mesh in ("single", "multi"):
        assert (tmp_path / mesh / "qwen2-0.5b__decode_32k.json").exists()


def test_torch_backend_does_not_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("torch")
    be = TorchBackend("cpu")
    assert be.name == "torch[cpu]" and be.supports_resident


def test_entry_points_default_to_the_card(monkeypatch):
    """With no backend named, every entry point resolves ``TorchBackend()``
    on CUDA — so on a CUDA-less host it raises instead of running on the
    CPU; the host oracle runs only when ``"numpy"`` is asked for.  The
    data pipeline's batches and the train driver default to the card too
    (AdamW and compression follow their tensors' device)."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.apps.common import run_app
    from repro_torch.core.compiler import CompileOptions
    from repro_torch.core.vector_vm import VectorVM
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import train
    from repro_torch.serve.dataflow import DataflowEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert CompileOptions().backend == "torch"
    app = ALL_APPS["murmur3"]()
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    for call in (lambda: make_backend(None),
                 lambda: run_app(app),
                 lambda: lowered.compile(),
                 lambda: VectorVM(lowered.result.dfg),
                 lambda: DataflowEngine(app.prog),
                 lambda: Pipeline(DataConfig(100, 8, 2)).batch(0),
                 lambda: train.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert run_app(app, backend="numpy").vm.backend.name == "numpy"


def test_resident_execution_is_refused():
    """The numpy oracle has no resident path: asking for one raises (the
    port's ``TorchBackend`` has one, on the card and on the CPU)."""
    from repro_torch.apps import ALL_APPS
    app = ALL_APPS["murmur3"]()
    compiled = app.fn.lower(**app.dram_init, **app.params,
                            **app.statics).compile("numpy")
    assert not make_backend("numpy").supports_resident
    assert TorchBackend("cpu").supports_resident
    with pytest.raises(ValueError, match="no resident path"):
        compiled.execute_batch([(app.dram_init, app.params)],
                               execution="resident")


def test_resident_refusal_points_at_the_ports_own_path():
    """The refusal names the port's backend, not the JAX package's
    (``make_backend("jax")`` raises in the port)."""
    from repro_torch.apps import ALL_APPS
    app = ALL_APPS["murmur3"]()
    compiled = app.fn.lower(**app.dram_init, **app.params,
                            **app.statics).compile("numpy")
    with pytest.raises(ValueError, match="backend='torch'") as err:
        compiled.execute_batch([(app.dram_init, app.params)],
                               execution="resident")
    assert "jax" not in str(err.value)
    with pytest.raises(ValueError, match="unknown executor backend"):
        make_backend("jax")


class _WindowedCPU(TorchBackend):
    """A CPU ``TorchBackend`` that claims no resident path (only the
    engine's bucket choice reads the flag here)."""
    supports_resident = False


@pytest.mark.parametrize("backend,want", [
    (lambda: TorchBackend("cpu"), (1, 2, 4, 8, 16, 32, 64)),
    (lambda: make_backend("numpy"), None),
    (lambda: _WindowedCPU("cpu"), None)])
def test_dataflow_buckets_follow_supports_resident(backend, want):
    """``bucket_sizes="auto"`` pads launches only on a backend with a
    resident path, whatever its name."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.serve.dataflow import DataflowEngine
    app = ALL_APPS["murmur3"]()
    compiled = app.fn.lower(**app.dram_init, **app.params,
                            **app.statics).compile(TorchBackend("cpu"))
    eng = DataflowEngine(compiled, backend=backend())
    assert eng.bucket_sizes == want


def _dfg_summary(dfg):
    """Dataclass reprs name no module, so equal graphs of the two packages
    print the same — once each ``replicate_group`` (an ``id()`` of the
    replicate statement) is renumbered in order of appearance."""
    groups = {}

    def renumber(m):
        return f"replicate_group={groups.setdefault(m.group(1), len(groups))}"

    ctxs = re.sub(r"replicate_group=(\d+)", renumber, repr(dfg.contexts))
    return ctxs, repr(dfg.links), dfg.entry, dfg.result_link


@pytest.mark.parametrize("name", sorted(REF_APPS))
def test_reference_ir_text_crosses_to_port(name):
    """The reference's post-pass IR text parses in the port, prints back the
    same text, and lowers to the same contexts and links."""
    result = ref_compile(REF_APPS[name]().prog)
    text = result.prog.as_text()
    prog = textio.parse_program(text)
    assert textio.program_to_text(prog) == text
    assert prog.as_text() == text
    want = _dfg_summary(ref_lowering.lower(result.prog))
    assert _dfg_summary(lowering.lower(prog)) == want
    assert _dfg_summary(result.dfg) == want

"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU, against
the reference's where both compute the same quantity.

Reduced configurations at small shapes stand in for the production cells:
``analyze_cell`` over a ``"fake"`` process group of 8 ranks on a 2x4 mesh;
``model_flops`` by the reference's formula; the per-device argument bytes
equal to the reference's compiled ``memory_analysis()`` of the same steps
on a 2x4 mesh of 8 host devices (in a subprocess); ``build_train_step``
with two microbatches against the reference's after one step; a failing
cell makes ``main()`` exit non-zero.  Each test destroys the process group
it makes, so no group leaks into another test of the same worker.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_reduced as ref_get_reduced
from repro.models.zoo import get_model as ref_get_model
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.params import from_numpy, leaves
from repro_torch.models.zoo import get_model

ROOT = Path(__file__).resolve().parents[1]

# small stand-ins for the production cells (same kinds, same names)
SMALL = {"train_4k": ShapeConfig("train_4k", 32, 8, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode")}

# (arch, cell) pairs held to the reference's compiled memory analysis: each
# family, the attention reshard (starcoder2's 6 heads on 4-way model
# parallelism, train), and arguments jit drops (encdec and vlm decode)
MEMORY_CELLS = [("qwen2-0.5b", "train_4k"), ("starcoder2-7b", "train_4k"),
                ("falcon-mamba-7b", "decode_32k"),
                ("recurrentgemma-9b", "decode_32k"),
                ("olmoe-1b-7b", "prefill_32k"),
                ("seamless-m4t-medium", "decode_32k"),
                ("internvl2-1b", "decode_32k")]


@pytest.fixture
def reduced(monkeypatch):
    """The dry-run on reduced configurations and ``SMALL`` shapes."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)


@pytest.fixture
def mesh_2x4():
    """A 2x4 mesh over a fake process group of 8 ranks, destroyed after."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_host_mesh(2, 4, device="cpu")
    finally:
        dist.destroy_process_group()


def test_analyze_cell_on_reduced_configs(reduced, mesh_2x4, tmp_path):
    keys = {"arch", "shape", "mesh", "chips", "trace_s", "memory_analysis",
            "model_flops", "tokens", "traced_flops", "roofline",
            "departures", "unused_argument_bytes"}
    for arch, cell in (("qwen2-0.5b", "train_4k"),
                       ("qwen2-0.5b", "prefill_32k"),
                       ("recurrentgemma-9b", "decode_32k")):
        r = dryrun.analyze_cell(arch, cell, "host", mesh=mesh_2x4,
                                outdir=str(tmp_path))
        saved = json.loads((tmp_path / "host" / f"{arch}__{cell}.json")
                           .read_text())
        assert saved == json.loads(json.dumps(r)) and set(r) == keys
        assert r["chips"] == 8 and r["traced_flops"] > 0
        assert r["roofline"] == {"compute_s": r["traced_flops"]
                                 / (8 * 989e12)}
        assert set(r["memory_analysis"]) == {"argument_size_in_bytes",
                                             "output_size_in_bytes"}
        gone = " ".join(d["key"] for d in r["departures"])
        for key in ("temp_size_in_bytes", "generated_code_size_in_bytes",
                    "hlo_bytes", "memory_s", "collective_bytes",
                    "collective_s", "_collective_bytes"):
            assert key in gone
    # the int8 cache and two microbatches trace too
    q8 = dryrun.analyze_cell("qwen2-0.5b", "decode_32k", "host",
                             mesh=mesh_2x4, save=False, kv_int8=True)
    bf = dryrun.analyze_cell("qwen2-0.5b", "decode_32k", "host",
                             mesh=mesh_2x4, save=False)
    assert q8["memory_analysis"]["argument_size_in_bytes"] \
        < bf["memory_analysis"]["argument_size_in_bytes"]
    mb = dryrun.analyze_cell("qwen2-0.5b", "train_4k", "host",
                             mesh=mesh_2x4, save=False, microbatch=2)
    assert mb["memory_analysis"] == json.loads(
        (tmp_path / "host" / "qwen2-0.5b__train_4k.json").read_text()
    )["memory_analysis"]
    with pytest.raises(ValueError, match="dense-family"):
        dryrun.analyze_cell("falcon-mamba-7b", "decode_32k", "host",
                            mesh=mesh_2x4, save=False, kv_int8=True)


def test_no_tpu_constant_in_the_port():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for const in ("197e12", "819e9", "50e9"):
            assert const not in text, (path, const)
    assert dryrun.PEAK_FLOPS == 989e12


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "seamless-m4t-medium"])
def test_model_flops_follow_reference_formula(reduced, arch):
    """``model_flops`` and ``tokens`` of every cell kind: 6·N·B·S (train),
    2·N·B·S (prefill), 2·N·B (decode), N the reference config's active
    parameters."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        n = ref_get_reduced(arch).active_params()
        mesh = make_host_mesh(1, 1, device="cpu")
        for cell, mult, tokens in (("train_4k", 6, 8 * 32),
                                   ("prefill_32k", 2, 8 * 64),
                                   ("decode_32k", 2, 8)):
            r = dryrun.analyze_cell(arch, cell, "host", mesh=mesh,
                                    save=False)
            assert r["tokens"] == tokens
            assert r["model_flops"] == mult * n * tokens
    finally:
        dist.destroy_process_group()


def test_argument_bytes_match_reference_memory_analysis(reduced, mesh_2x4):
    """Per-device argument bytes equal the reference's compiled
    ``memory_analysis().argument_size_in_bytes`` exactly.  Output bytes
    equal XLA's less its output tuple's index table, 8 bytes an output
    leaf (a departure the JSON names)."""
    code = textwrap.dedent(f"""
        import json, jax, numpy as np
        from jax.sharding import Mesh
        from repro.configs import get_reduced
        from repro.configs.base import ShapeConfig
        jax.devices()            # fixes the device count before the import
        import repro.launch.dryrun as rd
        rd.get_config = get_reduced
        rd.SHAPES = {{k: ShapeConfig(*v) for k, v in {
            {k: (v.name, v.seq_len, v.global_batch, v.kind)
             for k, v in SMALL.items()}!r}.items()}}
        # Auto axes: the reference's make_host_mesh gives Explicit ones,
        # on which its activation hints raise
        mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
        out = {{}}
        for arch, cell in {MEMORY_CELLS!r}:
            m = rd.lower_cell(arch, cell, mesh)[0].compile().memory_analysis()
            out[arch + "/" + cell] = [int(m.argument_size_in_bytes),
                                      int(m.output_size_in_bytes)]
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    got = {}
    for arch, cell in MEMORY_CELLS:
        r = dryrun.trace_cell(arch, cell, mesh_2x4)
        got[f"{arch}/{cell}"] = r
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    want = json.loads(stdout.splitlines()[-1])
    for tag, (arg, out) in want.items():
        r = got[tag]
        assert r["argument_size_in_bytes"] == arg, tag
        assert r["output_size_in_bytes"] + 8 * r["output_leaves"] == out, tag
    # the encoder and the vision projector are arguments no output needs
    assert got["seamless-m4t-medium/decode_32k"]["unused_argument_bytes"] > 0
    assert got["internvl2-1b/decode_32k"]["unused_argument_bytes"] > 0
    assert got["qwen2-0.5b/train_4k"]["unused_argument_bytes"] == 0


def test_microbatched_train_step_matches_reference(monkeypatch):
    """Reduced qwen2 in float32, a batch of 4 x 16 in two microbatches: one
    step of the port's ``build_train_step`` against the reference's (its
    ``lax.scan`` accumulation): loss within 1e-5, params, moments and the
    metrics within 1e-4 of max(1, |reference|)."""
    # importing the reference's dry-run sets XLA_FLAGS for 512 host
    # devices; put it back after the test, for the worker's next tests
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as ref_dryrun
    ref_zoo = ref_get_model(ref_get_reduced("qwen2-0.5b"))
    f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)
    ref_params = f32(ref_zoo.init_params(0))
    shape = ShapeConfig("s", 16, 4, "train")
    ref_batch = ref_zoo.make_batch(shape, seed=1)
    ref_state = ref_dryrun.adamw.init_state(ref_params)
    ref_step = jax.jit(ref_dryrun.build_train_step(ref_zoo, "chunked", 2))
    rp, rs, rm = ref_step(ref_params, ref_state, ref_batch)

    zoo = get_model(get_reduced("qwen2-0.5b"))
    params = from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    batch = zoo.make_batch(shape, seed=1, device="cpu")
    state = dryrun.adamw.init_state(params)
    p, s, m = dryrun.build_train_step(zoo, "chunked", 2)(params, state,
                                                         batch)

    def close(got, want, tol):
        want = np.asarray(want, np.float32)
        err = np.abs(got.detach().numpy() - want)
        assert np.all(err <= tol * np.maximum(1.0, np.abs(want))), \
            float(err.max())

    close(m["loss"], rm["loss"], 1e-5)
    for k in ("lr", "grad_norm"):
        close(m[k], rm[k], 1e-4)
    for got, want in ((p, rp), (s["m"], rs["m"]), (s["v"], rs["v"])):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            close(g, w, 1e-4)
    assert int(s["step"]) == int(rs["step"]) == 1


def test_failing_cell_exits_nonzero(reduced, monkeypatch, tmp_path,
                                    capsys):
    real = dryrun.cell_program

    def program(arch, shape_name, mesh, *a, **kw):
        if shape_name == "prefill_32k":
            raise ValueError("a sharding bug")
        return real(arch, shape_name, mesh, *a, **kw)

    monkeypatch.setattr(dryrun, "cell_program", program)
    monkeypatch.setattr(dryrun, "cells_for",
                        lambda cfg: ["prefill_32k", "decode_32k"])
    monkeypatch.setattr(dryrun, "ARCHS", {"qwen2-0.5b": None})
    with pytest.raises(SystemExit) as err:
        dryrun.main(["--all", "--mesh", "both", "--outdir", str(tmp_path)])
    assert err.value.code == ("2 cells failed: "
                              "single/qwen2-0.5b/prefill_32k, "
                              "multi/qwen2-0.5b/prefill_32k")
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert "[ok] single/qwen2-0.5b/decode_32k" in out
    assert (tmp_path / "multi" / "qwen2-0.5b__decode_32k.json").exists()
    # a second run skips the cells it has
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                 "--mesh", "both", "--outdir", str(tmp_path),
                 "--skip-existing"])
    assert "[skip] multi/qwen2-0.5b/decode_32k" in capsys.readouterr().out
    assert not dist.is_initialized()

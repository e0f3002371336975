"""The port's distribution layer (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``, the abstract specs) against the reference's,
on the CPU.

Every PartitionSpec the rules give — parameters, ZeRO moments, batches,
caches — equals the reference's (converted to a tuple) for every
architecture and cell on shape-only meshes of 16x16, 2x16x16, 4x2 and 1x8;
every abstract shape and dtype equals the reference's
``ShapeDtypeStruct``; the DTensor shard each rank keeps equals the
reference ``NamedSharding.devices_indices_map`` on 8 host devices (a
subprocess); the activation hints are no-ops without a mesh and on one
device, and the attention reshard takes the flat branch under a mesh
whose model axis does not divide the heads.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefPS

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import cells_for as ref_cells_for
from repro.distributed import sharding as ref_sh
from repro.kernels import ops as ref_ops
from repro.models import params as ref_params
from repro.models import transformer as ref_T
from repro.models.zoo import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault_tolerance import Supervisor
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import params as params_mod
from repro_torch.models import transformer as T
from repro_torch.models.params import P
from repro_torch.models.zoo import get_model
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
ARCH_NAMES = sorted(REF_ARCHS)


class FakeMesh:
    """Shape-only stand-in so rules can be tested at 16x16 without devices
    (the reference's own test double)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16}),
          FakeMesh({"data": 4, "model": 2}),
          FakeMesh({"data": 1, "model": 8})]


def _t(ps) -> tuple:
    return tuple(ps)


def _ref_leaves(tree):
    import jax
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (ref_params.P, jax.ShapeDtypeStruct)))


def _same_shape_dtype(t: torch.Tensor, ref) -> bool:
    return (t.is_meta and tuple(t.shape) == tuple(ref.shape)
            and str(t.dtype).removeprefix("torch.") == str(ref.dtype))


def _same_abstract(tree, ref_tree) -> None:
    assert set(tree) == set(ref_tree)
    for k in tree:
        if isinstance(tree[k], dict):
            _same_abstract(tree[k], ref_tree[k])
        else:
            assert _same_shape_dtype(tree[k], ref_tree[k]), \
                (k, tree[k].shape, tree[k].dtype, ref_tree[k])


# ---------------------------------------------------------------------------
# partition specs: every leaf of every architecture and cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_zero_pspecs_match_reference(arch):
    spec = params_mod.leaves(get_model(get_config(arch)).spec())
    ref_spec = _ref_leaves(ref_get_model(ref_get_config(arch)).spec())
    assert len(spec) == len(ref_spec)
    for p, rp in zip(spec, ref_spec):
        assert (p.shape, p.axes, p.dtype) == (rp.shape, rp.axes, rp.dtype)
        for m in MESHES:
            assert sh.param_pspec(p, m) == _t(ref_sh.param_pspec(rp, m))
            assert sh.zero_pspec(p, m) == _t(ref_sh.zero_pspec(rp, m))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_pspecs_match_reference(arch):
    """``batch_pspec`` of every cell's batch specs (with and without
    sequence sharding) and ``cache_pspec`` of every leaf of the family's
    ``abstract_cache`` at every cell, with the decode inputs and, for the
    dense family, the int8 cache."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    zoo, ref_zoo = get_model(cfg), ref_get_model(ref_cfg)
    for cell in ref_cells_for(ref_cfg):
        shape, ref_shape = SHAPES[cell], REF_SHAPES[cell]
        batch = zoo.batch_specs(shape)
        ref_batch = ref_zoo.batch_specs(ref_shape)
        assert list(batch) == list(ref_batch)
        dec = zoo.decode_input_specs(shape)
        ref_dec = ref_zoo.decode_input_specs(ref_shape)
        caches = [(dec["cache"], ref_dec["cache"])]
        if cfg.family == "dense":
            caches.append((T.abstract_cache_q8(cfg, 4, 64),
                           ref_T.abstract_cache_q8(ref_cfg, 4, 64)))
        for m in MESHES:
            for k, (shp, _) in batch.items():
                assert shp == ref_batch[k].shape
                for seq_shard in (False, True):
                    got = sh.batch_shardings(
                        {k: torch.empty(shp, device="meta")}, m,
                        seq_shard=seq_shard)[k].spec
                    want = ref_sh.batch_pspec(
                        shp, m, seq_dim=1 if len(shp) >= 2 else None,
                        seq_shard=seq_shard)
                    assert got == _t(want), (cell, k, seq_shard)
            for name in ("token", "position"):
                assert sh.batch_pspec(tuple(dec[name].shape), m) == _t(
                    ref_sh.batch_pspec(ref_dec[name].shape, m))
            for cache, ref_cache in caches:
                assert list(cache) == list(ref_cache)
                for k, t in cache.items():
                    assert sh.cache_pspec(k, tuple(t.shape), m) == _t(
                        ref_sh.cache_pspec(k, ref_cache[k].shape, m)), \
                        (cell, k)
                assert {k: s.spec for k, s in
                        sh.cache_shardings(cache, m).items()} == {
                    k: _t(ref_sh.cache_pspec(k, v.shape, m))
                    for k, v in ref_cache.items()}


def test_cache_pspec_raises_on_unknown_leaf_as_reference():
    m = MESHES[0]
    for bad in ("kv", "rec_k", "h0"):
        with pytest.raises(KeyError):
            ref_sh.cache_pspec(bad, (2, 4, 8, 16, 4), m)
        with pytest.raises(KeyError):
            sh.cache_pspec(bad, (2, 4, 8, 16, 4), m)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_pspec_tree_matches_reference(arch):
    got = params_mod.leaves(params_mod.pspec_tree(
        get_model(get_config(arch)).spec(), sh.PARAM_RULES))
    import jax
    want = jax.tree.leaves(
        ref_params.pspec_tree(ref_get_model(ref_get_config(arch)).spec(),
                              ref_sh.PARAM_RULES),
        is_leaf=lambda x: isinstance(x, RefPS))
    assert [_t(w) for w in want] == got
    assert all(isinstance(g, sh.PartitionSpec) for g in got)


# twins of the reference's four rule tests (tests/test_distributed.py)

def test_param_pspec_divisibility():
    m = FakeMesh({"data": 16, "model": 16})
    assert sh.param_pspec(P((1024, 4096), ("embed", "ff")), m) \
        == sh.PS(None, "model")
    # non-divisible vocab falls back to replication
    assert sh.param_pspec(P((256206, 1024), ("vocab", "embed")), m) \
        == sh.PS(None, None)
    assert sh.param_pspec(P((151936, 1024), ("vocab", "embed")), m) \
        == sh.PS("model", None)


def test_zero_pspec_shards_largest_free_dim():
    m = FakeMesh({"data": 16, "model": 16})
    ps = sh.zero_pspec(P((8192, 4096), ("embed", "ff")), m)
    assert ps == sh.PS("data", "model")


def test_batch_pspec_multi_pod_and_batch1():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert sh.batch_pspec((256, 4096), m) == sh.PS(("pod", "data"), None)
    assert sh.batch_pspec((1, 524288), m) == sh.PS(None, None)  # long_500k


def test_cache_pspec_head_fallback_to_seq():
    m = FakeMesh({"data": 16, "model": 16})
    # kv heads 8 < 16 -> fall back to sharding the KV sequence dim
    ps = sh.cache_pspec("k", (64, 128, 8, 32768, 128), m)
    assert ps == sh.PS(None, "data", None, "model", None)
    # kv heads 16 -> heads shard
    ps = sh.cache_pspec("k", (24, 128, 16, 32768, 64), m)
    assert ps == sh.PS(None, "data", "model", None, None)
    # ssm state: width shards
    ps = sh.cache_pspec("h", (64, 1, 8192, 16), m)
    assert ps == sh.PS(None, None, "model", None)


def test_named_sharding_placements_and_refusals():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    ns = sh.NamedSharding(m, sh.PS(("pod", "data"), None, "model"))
    assert ns.placements() == [Shard(0), Shard(0), Shard(2)]
    assert ns.local_shape((256, 3, 32)) == (8, 3, 2)
    assert sh.replicated(m).placements() == [Replicate()] * 3
    for bad in (sh.PS("expert"), sh.PS("model", "model"),
                sh.PS(("data", "pod"))):
        with pytest.raises(ValueError):
            sh.NamedSharding(m, bad).placements()
    with pytest.raises(ValueError, match="does not divide"):
        ns.local_shape((100, 3, 32))


# ---------------------------------------------------------------------------
# DTensor shards against the reference's device index map (8 host devices)
# ---------------------------------------------------------------------------

def test_dtensor_shards_match_reference_index_map():
    """For a 2x2x2 and a 2x4 mesh, each rank's ``to_local()`` of a
    ``NamedSharding.distribute``d tensor is exactly the block that the
    reference ``NamedSharding.devices_indices_map`` gives its device (the
    rank's flat position in the mesh), for specs with tuple axes."""
    code = textwrap.dedent("""
        import jax, numpy as np, torch
        import torch.distributed as dist
        from jax.sharding import Mesh as JMesh, NamedSharding as JNS
        from jax.sharding import PartitionSpec as JPS
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import make_host_mesh, Mesh
        devs = jax.devices()
        assert len(devs) == 8
        cases = [
            ((2, 2, 2), ("pod", "data", "model"), (8, 8, 6), [
                (("pod", "data"), "model"), (None, ("pod", "data", "model")),
                ("model", ("pod", "data"), None), ("pod", None, "model"),
                (("data", "model"), None, "pod"), ()]),
            ((2, 4), ("data", "model"), (8, 12), [
                (("data", "model"),), ("model", "data"), (None, "model"),
                ("data",), ()]),
        ]
        n = 0
        for dims, axes, shape, specs in cases:
            jmesh = JMesh(np.array(devs).reshape(dims), axes)
            g = np.arange(np.prod(shape)).reshape(shape)
            for spec in specs:
                idx = JNS(jmesh, JPS(*spec)).devices_indices_map(shape)
                for rank in range(8):
                    dist.init_process_group("fake", store=FakeStore(),
                                            rank=rank, world_size=8)
                    try:
                        from torch.distributed.device_mesh import DeviceMesh
                        dm = DeviceMesh("cpu", torch.arange(8).reshape(dims),
                                        mesh_dim_names=axes)
                        mesh = Mesh(axes, dict(zip(axes, dims)),
                                    torch.device("cpu"), dm)
                        ns = sh.NamedSharding(mesh, sh.PS(*spec))
                        local = ns.distribute(torch.from_numpy(g)).to_local()
                        want = g[idx[devs[rank]]]
                        assert local.shape == want.shape, (spec, rank)
                        assert np.array_equal(local.numpy(), want), \\
                            (spec, rank)
                        assert tuple(local.shape) == ns.local_shape(shape)
                        n += 1
                    finally:
                        dist.destroy_process_group()
        print(n)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert int(out.stdout.split()[-1]) == 8 * (6 + 5)


# ---------------------------------------------------------------------------
# abstract values: shapes and dtypes equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_specs_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    zoo, ref_zoo = get_model(cfg), ref_get_model(ref_cfg)
    params, ref_abs = zoo.abstract_params(), ref_zoo.abstract_params()
    _same_abstract(params, ref_abs)
    _same_abstract(params_mod.abstract(zoo.spec()), ref_abs)
    state = adamw.abstract_state(params)
    ref_state = ref_adamw.abstract_state(ref_abs)
    _same_abstract({"m": state["m"], "v": state["v"]},
                   {"m": ref_state["m"], "v": ref_state["v"]})
    assert _same_shape_dtype(state["step"], ref_state["step"])
    for cell in ref_cells_for(ref_cfg):
        shape = SHAPES[cell]
        b, s = shape.global_batch, shape.seq_len
        _same_abstract(zoo.abstract_cache(b, s),
                       ref_zoo.abstract_cache(b, s))
        _same_abstract(zoo.mod.abstract_cache(cfg, b, s),
                       ref_zoo.mod.abstract_cache(ref_cfg, b, s))
        _same_abstract(zoo.decode_input_specs(shape),
                       ref_zoo.decode_input_specs(REF_SHAPES[cell]))
    if cfg.family == "encdec":
        _same_abstract(zoo.mod.abstract_cache(cfg, 2, 64, enc_len=128),
                       ref_zoo.mod.abstract_cache(ref_cfg, 2, 64,
                                                  enc_len=128))


def test_init_cache_is_abstract_cache_zeroed():
    """``init_cache`` of every family keeps ``abstract_cache``'s leaves
    (the SSM's conv window defaults to float32 there, bfloat16 here, as
    in the reference)."""
    for arch in ("qwen2-0.5b", "recurrentgemma-9b", "seamless-m4t-medium",
                 "falcon-mamba-7b", "olmoe-1b-7b", "internvl2-1b"):
        cfg = get_reduced(arch)
        zoo = get_model(cfg)
        got = zoo.init_cache(2, 48, device="cpu")
        want = zoo.abstract_cache(2, 48)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape and not got[k].any()
            assert got[k].dtype == want[k].dtype or \
                (cfg.family == "ssm" and k == "conv")


# ---------------------------------------------------------------------------
# activation hints and the attention reshard
# ---------------------------------------------------------------------------

def test_act_hint_noop_without_mesh():
    sh.set_act_mesh(None)
    x = torch.ones((4, 8))
    assert sh.act_hint(x, "data", None) is x
    assert sh.act_mesh_axis("model") == 1


def test_act_hint_with_host_mesh():
    """The twin of the reference's ``test_act_hint_with_host_mesh``, which
    fails in the reference (its mesh's axes are Explicit)."""
    mesh = make_host_mesh(1, 1, device="cpu")
    sh.set_act_mesh(mesh)
    try:
        x = torch.ones((4, 8))
        y = sh.act_hint(x, "data", "model")
        assert y is x and torch.equal(y, x)
        assert sh.act_mesh_axis("data") == sh.act_mesh_axis("model") == 1
    finally:
        sh.set_act_mesh(None)


def test_act_hint_redistributes_a_dtensor_on_the_active_mesh():
    """On a 2x4 mesh over a fake group of 8 ranks, a replicated DTensor is
    redistributed to the hint's layout (non-divisible entries dropped); a
    plain tensor, and a DTensor with no mesh active, stay as they are."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_host_mesh(2, 4, device="cpu")
        x = sh.replicated(mesh).distribute(torch.arange(48.0).reshape(8, 6))
        assert sh.act_hint(x, ("data", "model"), "model") is x
        sh.set_act_mesh(mesh)
        try:
            y = sh.act_hint(x, ("data", "model"), "model")
            plain = torch.ones(8, 6)
            assert sh.act_hint(plain, "data", None) is plain
        finally:
            sh.set_act_mesh(None)
        # dim 1 (6) does not divide by 4: dropped
        assert list(y.placements) == [Shard(0), Shard(0)]
        assert y.to_local().shape == (1, 6)
        assert list(x.placements) == [Replicate(), Replicate()]
    finally:
        dist.destroy_process_group()


def _starcoder_inputs(b, s):
    cfg = get_reduced("starcoder2-7b")          # 6 heads, 2 kv heads
    rng = np.random.default_rng(5)
    params = get_model(cfg).init_params(3, device="cpu")
    lp = {k: v.float() for k, v in T.layer_params(params, 0)["attn"].items()}
    x = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model))
                         .astype(np.float32))
    return cfg, lp, x


def test_attention_reshard_takes_flat_branch(monkeypatch):
    """Under an active 2x4 mesh, reduced starcoder2's 6 heads do not divide
    the model axis and a batch of 8 divides the full mesh: ``attention``
    reshards and calls ``ops.mha(flat=True)``.  Its float32 output equals
    the grouped branch's (no mesh) within 2e-5, and the flat chunked
    attention equals the reference's ``ops.mha(flat=True,
    impl="chunked")`` within 2e-5."""
    cfg, lp, x = _starcoder_inputs(8, 24)
    positions = T._positions(8, 24, x.device)
    seen = []
    real = ops.mha

    def spy(*a, **kw):
        seen.append(kw.get("flat", False))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mha", spy)
    grouped, _ = L.attention(lp, x, cfg, positions, impl="chunked")
    sh.set_act_mesh(FakeMesh({"data": 2, "model": 4}))
    try:
        flat, (k, v) = L.attention(lp, x, cfg, positions, impl="chunked")
        # a batch that does not divide the mesh keeps the grouped branch
        L.attention(lp, x[:4], cfg, positions[:4], impl="chunked")
    finally:
        sh.set_act_mesh(None)
    assert seen == [False, True, False]
    assert torch.allclose(flat, grouped, atol=2e-5, rtol=0)

    q, k, v = L._project_qkv(lp, x, cfg, positions)
    got = real(q, k, v, causal=True, impl="chunked", flat=True)
    want = ref_ops.mha(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                       jnp.asarray(v.numpy()), causal=True, impl="chunked",
                       flat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_attention_unchanged_on_one_device():
    """On a 1x1 mesh the reshard never runs: outputs are bit-identical to
    no mesh, on every impl."""
    cfg, lp, x = _starcoder_inputs(8, 24)
    positions = T._positions(8, 24, x.device)
    for impl in ("chunked", "naive", "kernel"):
        want, _ = L.attention(lp, x, cfg, positions, impl=impl)
        sh.set_act_mesh(make_host_mesh(1, 1, device="cpu"))
        try:
            got, _ = L.attention(lp, x, cfg, positions, impl=impl)
        finally:
            sh.set_act_mesh(None)
        assert torch.equal(got, want)


def test_moe_hints_are_value_noops_under_a_mesh():
    """The expert-parallel hints around ``expert_fn`` leave plain tensors
    as they are: both routes give the same bits under an active 2x4 mesh
    as without one."""
    rng = np.random.default_rng(2)
    t, d, e, k, c = 16, 8, 4, 2, 6
    tokens = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    gates = torch.from_numpy(rng.random((t, k)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, e, (t, k)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((e, d, d)).astype(np.float32))
    seen = []

    def expert_fn(xd):
        seen.append(tuple(xd.shape))
        return torch.bmm(xd, w)

    for impl in ops.MOE_IMPLS:
        want = ops.moe_dispatch_combine(tokens, gates, idx, e, c, expert_fn,
                                        impl=impl)
        sh.set_act_mesh(FakeMesh({"data": 2, "model": 4}))
        try:
            got = ops.moe_dispatch_combine(tokens, gates, idx, e, c,
                                           expert_fn, impl=impl)
        finally:
            sh.set_act_mesh(None)
        assert torch.equal(got, want)
    assert seen == [(e, c, d)] * 4


# ---------------------------------------------------------------------------
# meshes, and restore onto a mesh
# ---------------------------------------------------------------------------

def test_meshes_need_their_devices(monkeypatch):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="2 cpu devices needed"):
        make_host_mesh(2, 1, device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh()
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 16, "model": 16}
        assert mesh.device_mesh.mesh.shape == (16, 16)
        with pytest.raises(RuntimeError, match="512 ranks"):
            make_production_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()
    host = make_host_mesh(1, 1, device="cpu")
    assert host.device_mesh is None and host.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(1, 1)


def test_elastic_reshard_restore(tmp_path):
    """The twin of the reference's: a checkpoint saved unsharded restores
    under a sharding tree on the 1x1 CPU mesh with identical values, and
    ``Supervisor.run`` restores through one."""
    mesh = make_host_mesh(1, 1, device="cpu")
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    ckpt.save(str(tmp_path), 1, tree)
    sharding = {"w": sh.NamedSharding(mesh, sh.PS(None, None))}
    out = ckpt.restore(str(tmp_path), 1, tree, sharding)
    assert torch.equal(out["w"], tree["w"]) and out["w"].device == mesh.device
    out = ckpt.restore(str(tmp_path), 1, tree, sh.replicated(mesh))
    assert torch.equal(out["w"], tree["w"])

    sup = Supervisor(str(tmp_path / "sup"), ckpt_every=2)
    sup.run({"x": torch.zeros(())}, lambda s, i: {"x": s["x"] + i}, 4,
            devices="cpu")
    again = Supervisor(str(tmp_path / "sup"), ckpt_every=2)
    state, step = again.run({"x": torch.zeros(())},
                            lambda s, i: {"x": s["x"] + i}, 6,
                            devices={"x": sh.replicated(mesh)})
    assert step == 6 and float(state["x"]) == 15.0
    assert again.log[0] == "resumed from step 4"

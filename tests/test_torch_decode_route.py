"""The route of the decode attention over the KV cache, on the CPU.

``layers.decode_attention_step`` sends the attention to the hand-written
``decode_attention`` kernel for a plain CUDA cache; every other cache (CPU, DTensor, meta) keeps the grouped float32
reference, ``decode_mha(impl="ref")``.  Here: the route each kind of
input gets, a CPU decode step's counters (reference rows only), a
DTensor decode step on a one-rank mesh equal bit for bit to the plain
one, and the kernel route forced on a CPU cache (the kernel's plain
twin) against the reference route, with the keys it counts.  The kernel
route itself is held on the card in ``tests/test_torch_cuda.py``; the
DTensor case runs on the card too (marked ``cuda``).
"""
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params
from repro_torch.models.zoo import get_model

ARCHS = ("qwen2-0.5b", "olmoe-1b-7b")


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _layer_inputs(cfg, b=2, s=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 1, cfg.d_model, generator=g).to(torch.bfloat16)
    ck, cv = (torch.randn(b, cfg.n_kv_heads, s, cfg.hd, generator=g)
              .to(torch.bfloat16) for _ in range(2))
    return x, ck, cv


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_reference_route_off_the_card(device):
    cfg = get_reduced("qwen2-0.5b")
    cache = torch.empty(2, cfg.n_kv_heads, 8, cfg.hd, dtype=torch.bfloat16,
                        device=device)
    assert L._decode_route(cache) == "ref"


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_decode_step_counts_reference_rows(arch, monkeypatch):
    """One decode step of B = 3 slots: every layer's attention goes to
    ``decode_mha(impl="ref")``, and the recorder counts layers x B x Hkv
    reference rows, no kernel rows and no keys (the MoE's own counters
    aside)."""
    zoo = get_model(get_reduced(arch))
    cfg = zoo.cfg
    params = zoo.init_params(0, device="cpu")
    cache = zoo.init_cache(3, 24, device="cpu")
    impls = []
    inner = ops.decode_mha

    def spy(q, k, v, lengths, impl="kernel"):
        impls.append(impl)
        return inner(q, k, v, lengths, impl)

    monkeypatch.setattr(ops, "decode_mha", spy)
    token = torch.tensor([[5], [7], [11]], dtype=torch.int32)
    position = torch.tensor([0, 9, 23], dtype=torch.int32)
    tracing.enable()
    zoo.decode_step(params, token, cache, position)
    c = {k: v for k, v in tracing.drain()["counters"].items()
         if k[0].startswith("decode.")}
    assert impls == ["ref"] * cfg.n_layers
    assert c == {("decode.ref_rows", "decode.kv"):
                 cfg.n_layers * 3 * cfg.n_kv_heads}


def _one_rank_mesh(device_type: str):
    """A one-rank process group (gloo on the CPU, nccl on the card) and a
    ``DeviceMesh`` over it; the caller destroys the group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo" if device_type == "cpu" else "nccl",
                            store=dist.HashStore(), rank=0, world_size=1)
    return DeviceMesh(device_type, [0])


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.cuda)])
def test_dtensor_cache_keeps_the_reference_route(device, monkeypatch):
    """A decode attention step on replicated DTensors over a one-rank mesh
    (gloo on the CPU, nccl on the card): the reference route (its rows
    counted as such, no ``decode_attention`` launch), every output a
    DTensor equal bit for bit to the plain step's on the reference route
    (forced on the card, where a plain cache takes the kernel)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.decode_attention import decode_attention
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = get_reduced("qwen2-0.5b")
    lp = layer_params(get_model(cfg).init_params(0, device=device), 0)["attn"]
    x, ck, cv = (t.to(device) for t in _layer_inputs(cfg))
    pos = torch.tensor([3, 15], dtype=torch.int32, device=device)
    with monkeypatch.context() as m:
        m.setattr(L, "_decode_route", lambda c: "ref")
        want = L.decode_attention_step(lp, x, cfg, ck, cv, pos)
    mesh = _one_rank_mesh(device)
    try:
        def rep(t):
            return distribute_tensor(t, mesh, [Replicate()])
        assert L._decode_route(rep(ck)) == "ref"
        before = decode_attention.launches
        tracing.enable()
        with implicit_replication():
            got = L.decode_attention_step({k: rep(v) for k, v in lp.items()},
                                          rep(x), cfg, rep(ck), rep(cv),
                                          rep(pos))
        c = tracing.drain()["counters"]
        assert decode_attention.launches == before
        assert all(sh.is_dtensor(t) for t in got)
        assert all(torch.equal(g.full_tensor(), w)
                   for g, w in zip(got, want))
    finally:
        dist.destroy_process_group()
    assert c == {("decode.ref_rows", "decode.kv"): 2 * cfg.n_kv_heads}


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_forced_on_the_cpu(arch, monkeypatch):
    """The kernel route forced on a CPU cache (``decode_mha(impl=
    "kernel")`` runs the kernel's plain twin there) over positions 0, 7,
    S - 1 and past S: logits within bf16 rounding of the reference
    route's, and the keys counted as read are min(position + 1, S) a kv
    row, of S held."""
    zoo = get_model(get_reduced(arch))
    cfg = zoo.cfg
    params = zoo.init_params(0, device="cpu")
    s_len = 24
    position = torch.tensor([0, 7, s_len - 1, s_len + 16], dtype=torch.int32)
    token = torch.tensor([[5], [7], [11], [13]], dtype=torch.int32)
    g = torch.Generator().manual_seed(1)
    cache = {k: torch.randn(t.shape, generator=g).to(t.dtype)
             for k, t in zoo.init_cache(4, s_len, device="cpu").items()}
    want, _, _ = zoo.decode_step(params, token, cache, position)
    monkeypatch.setattr(L, "_decode_route", lambda c: "kernel")
    tracing.enable()
    got, _, _ = zoo.decode_step(params, token, cache, position)
    c = {k[0]: v for k, v in tracing.drain()["counters"].items()
         if k[0].startswith("decode.")}
    rows = cfg.n_layers * 4 * cfg.n_kv_heads
    live = int(torch.clamp(position + 1, max=s_len).sum())
    assert c == {"decode.kernel_rows": rows,
                 "decode.keys_read": cfg.n_layers * cfg.n_kv_heads * live,
                 "decode.keys_held": rows * s_len}
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale

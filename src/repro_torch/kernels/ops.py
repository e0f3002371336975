"""ops — the VectorVM executor entry points and the LM attention entry
points on torch tensors.

VectorVM windows are the hot loops of ``core/vector_vm.py`` behind
:class:`~repro_torch.core.backend.TorchBackend` (see DESIGN.md §3).
Contract: int64 numpy in, int64 numpy out, bit-identical to the
``NumpyBackend`` oracle.  Each call moves its window to ``device`` as int32
and brings the result back.  Element-wise windows and run selection are
plain torch ops; compaction and segmented reduction call the
``stream_compact`` and ``segment_reduce`` kernels, which launch their CUDA
kernels on a CUDA device and run their plain torch versions on the CPU.

Integer traps of torch, avoided here: integer division by zero raises on the
CPU and ``INT_MIN / -1`` kills the process, so divisors are made safe first
and the results patched; ``torch.remainder`` floors where the IR truncates
(``torch.fmod`` is right); shifts by 32 or more are not masked by torch;
there is no full uint32 arithmetic, so unsigned ops run in int64 on
``a & 0xFFFFFFFF``.

Attention (the reference's ``kernels/ops.py:582-859``): ``mha`` and
``decode_mha`` with GQA, the grouped full-softmax reference
``_grouped_ref``, and the chunked flash-style paths.  The reference's
``impl="pallas"`` route is ``impl="kernel"`` here: it launches the
hand-written ``flash_attention`` / ``decode_attention`` kernels on a CUDA
tensor and runs their plain torch versions on a CPU tensor.  Where the
reference repeats kv heads to match q's before its kernels, the port's
kernels index the kv row of each query row (GQA by index, no copy).
``"chunked"`` and ``"ref"`` keep their meaning.  ``chunked_attention`` and
``grouped_chunked_attention`` are ``torch.autograd.Function``s with the
reference's flash backwards (its ``custom_vjp``s, in plain torch); the
``"ref"`` route differentiates through torch's autograd.  The kernels have
no backward: called on inputs that require grad, with grad enabled, they
raise, as ``jax.grad`` through a Pallas kernel fails in the reference.

Recurrences (the reference's ``kernels/ops.py:862-979``): ``ssm`` and
``rg_lru_scan`` with ``impl="kernel"`` launch the hand-written ``ssm_scan``
and ``rg_lru`` kernels (their plain torch loops on a CPU tensor);
``ssm_assoc``, ``ssm_chunked``, ``rg_lru_assoc`` and ``rg_lru_chunked`` are
the reference's associative-scan formulations in plain torch, taking any S.

Hash probe (the reference's ``kernels/ops.py:530-581``): ``hash_lookup``
calls the hand-written ``hash_probe`` kernel on a CUDA tensor, whatever the
table's size, and its plain probe loop (the reference's
``_hash_lookup_xla``) on a CPU tensor.

MoE (the reference's ``kernels/ops.py:984-1038``): ``moe_dispatch_combine``
with ``impl="kernel"`` (the reference's ``"pallas"``) dispatches through the
hand-written ``moe_dispatch`` kernel, with ``"scatter"`` through a plain
scatter-add; ``moe_dense_einsum`` is the one-hot MapReduce baseline.  All
three share one deterministic combine.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed import sharding as _sh
from ..models.params import resolve_device
from . import ref as _ref
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .hash_probe import hash_probe
from .moe_dispatch import moe_dispatch
from .rg_lru import rg_lru
from .segment_reduce import segment_reduce_flat
from .ssm_scan import ssm_scan
from .stream_compact import stream_compact_flat

_INT32_MIN = -(1 << 31)
_I64 = np.int64


def _dev(a, device) -> torch.Tensor:
    """int64 numpy window (already 32-bit wrapped) -> int32 tensor."""
    return torch.from_numpy(np.asarray(a, _I64).astype(np.int32)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(_I64)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor with two's-complement wrap."""
    return (((x - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.long() & 0xFFFFFFFF


# ---- element-wise body windows ----


def _ew(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IR binop on int32 tensors, 32-bit wrap semantics (== numpy oracle)."""
    i32 = torch.int32
    if op == "add":
        return _wrap32(a.long() + b.long())
    if op == "sub":
        return _wrap32(a.long() - b.long())
    if op == "mul":
        return _wrap32(a.long() * b.long())
    if op in ("sdiv", "smod"):
        # C-style truncation; b == 0 gives 0, INT_MIN / -1 gives INT_MIN
        # (and remainder 0), as wrap32 does
        trap = (a == _INT32_MIN) & (b == -1)
        bad = (b == 0) | trap
        safe = torch.where(bad, torch.ones_like(b), b)
        if op == "sdiv":
            q = torch.div(a, safe, rounding_mode="trunc")
            q = torch.where(trap, torch.full_like(q, _INT32_MIN), q)
            return torch.where(b == 0, torch.zeros_like(q), q)
        return torch.where(bad, torch.zeros_like(a), torch.fmod(a, safe))
    if op in ("udiv", "umod"):
        au, bu = _u32(a), _u32(b)
        safe = torch.where(bu == 0, torch.ones_like(bu), bu)
        r = (torch.div(au, safe, rounding_mode="floor") if op == "udiv"
             else au % safe)
        return _wrap32(torch.where(bu == 0, torch.zeros_like(r), r))
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "shl":
        return _wrap32(_u32(a) << (b.long() & 31))
    if op == "lshr":
        return _wrap32(_u32(a) >> (b.long() & 31))
    if op == "ashr":
        return torch.bitwise_right_shift(a, b & 31)
    if op == "eq":
        return (a == b).to(i32)
    if op == "ne":
        return (a != b).to(i32)
    if op == "slt":
        return (a < b).to(i32)
    if op == "sle":
        return (a <= b).to(i32)
    if op == "sgt":
        return (a > b).to(i32)
    if op == "sge":
        return (a >= b).to(i32)
    if op == "ult":
        return (_u32(a) < _u32(b)).to(i32)
    if op == "ule":
        return (_u32(a) <= _u32(b)).to(i32)
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    raise NotImplementedError(op)


def vm_binop(op: str, a, b, device="cpu") -> np.ndarray:
    return _host(_ew(op, _dev(a, device), _dev(b, device)))


def vm_unop(op: str, a, device="cpu") -> np.ndarray:
    t = _dev(a, device)
    if op == "neg":
        return _host(_wrap32(-t.long()))
    if op == "not":
        return _host((t == 0).to(torch.int32))
    raise NotImplementedError(op)


def vm_select(c, a, b, device="cpu") -> np.ndarray:
    return _host(torch.where(_dev(c, device) != 0, _dev(a, device),
                             _dev(b, device)))


# ---- window compaction (filter / discard / barrier lowering) ----


def vm_compact(keep, kinds, payload, device="cpu"
               ) -> tuple[np.ndarray, np.ndarray | None]:
    """Window compaction with the kinds column riding along the payload.

    ``keep`` bool [N]; ``kinds`` int64 [N]; ``payload`` int64 [N, D] or None.
    The kinds are stacked as column 0 so one kernel pass compacts both.
    """
    n = len(kinds)
    d = 0 if payload is None else payload.shape[1]
    if n == 0:
        return (np.zeros(0, _I64),
                None if payload is None else np.zeros((0, d), _I64))
    cols = np.zeros((n, d + 1), np.int32)
    cols[:, 0] = kinds
    if d:
        cols[:, 1:] = payload
    # one device->host copy: the zero-padded rows, then the count
    flat = _host(stream_compact_flat(_dev(keep, device),
                                     torch.from_numpy(cols).to(device)))
    out = flat[:-1].reshape(n, d + 1)[:int(flat[-1])]
    return out[:, 0], (out[:, 1:] if payload is not None else None)


# ---- windowed segmented reduction ----


def vm_segment_reduce(kinds, vals, op: str, init: int, acc: int,
                      group_open: bool, device="cpu"
                      ) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """Windowed segmented reduction (executor entry point): every op, any
    carry, values or none — all on ``device``, nothing on host numpy."""
    # one device->host copy: the zero-padded kinds and values, the count,
    # the carry
    flat = _host(segment_reduce_flat(
        _dev(kinds, device), None if vals is None else _dev(vals, device),
        init=init, op=op, acc=acc, group_open=group_open))
    n2 = 2 * len(kinds)
    m = int(flat[2 * n2])
    return (flat[:m], flat[n2:n2 + m], int(flat[2 * n2 + 1]),
            bool(flat[2 * n2 + 2]))


# ---- merge / zip run selection ----


def vm_data_run(kinds, device="cpu") -> int:
    """Length of the leading run of data tokens."""
    n = len(kinds)
    if n == 0:
        return 0
    bar = _dev(kinds, device) != 0
    first = torch.where(bar.any(), torch.argmax(bar.to(torch.int32)), n)
    return int(first)


def vm_first_mismatch(ref, others, device="cpu") -> int:
    """First index where any of ``others`` differs from ``ref``."""
    n = len(ref)
    if not others or n == 0:
        return n
    stack = _dev(np.stack([np.asarray(a, _I64)[:n]
                           for a in [ref] + list(others)]), device)
    mism = (stack[1:] != stack[:1]).any(0)
    first = torch.where(mism.any(), torch.argmax(mism.to(torch.int32)), n)
    return int(first)


# ---- hash probe ----

def hash_lookup(keys, table_k, table_v, n_slots: int, max_probes: int = 16,
                device=None):
    """Open-addressing lookup of ``keys`` in a table padded to ``2 *
    n_slots``.  Returns (values [N], found [N]) as int32 tensors.

    Tensors stay on their device; numpy inputs move to ``device`` (``None``:
    the card), wrapped to int32 as the reference's ``jnp.asarray`` wraps
    int64 (keys at or above 2^31 become negative; the hash reads them as
    uint32 again).  The reference sends tables above 2^20 entries (its
    VMEM limit) to an XLA gather loop with the same semantics; here the
    kernel takes every size on a CUDA tensor."""
    dev = keys.device if isinstance(keys, torch.Tensor) \
        else resolve_device(device, "hash_lookup")

    def i32(a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.asarray(a, _I64))
        if t.dtype != torch.int32:
            t = _wrap32(t.long())
        return t.to(dev).contiguous()

    return hash_probe(i32(keys), i32(table_k), i32(table_v), n_slots,
                      max_probes)


# ---- attention ----

ATTENTION_IMPLS = ("kernel", "chunked", "ref")


def _check_impl(impl: str) -> None:
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (have "
                         f"{ATTENTION_IMPLS}; the reference's 'pallas' route "
                         "is 'kernel' here)")


def _match_heads(k: torch.Tensor, hq: int) -> torch.Tensor:
    """Repeat each kv head ``hq // hkv`` times (``jnp.repeat`` on axis 1)."""
    hkv = k.shape[1]
    return k if hkv == hq else k.repeat_interleave(hq // hkv, dim=1)


def mha(q, k, v, causal: bool = True, impl: str = "kernel",
        flat: bool = False):
    """Multi-head attention with GQA. q [B, Hq, S, D], k/v [B, Hkv, S, D].

    ``"kernel"`` folds heads into the batch and passes K/V as they are
    (the kernel reads kv row ``bh // G`` for query row ``bh``); ``flat``
    with ``"chunked"``/``"ref"`` folds heads with kv heads repeated to
    match q's; otherwise ``"chunked"`` and ``"ref"`` run grouped 5-D
    attention (q viewed as [B, Hkv, G, S, D], kv never repeated)."""
    _check_impl(impl)
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if impl == "kernel":
        out = flash_attention(q.reshape(b * hq, sq, d).contiguous(),
                              k.reshape(b * hkv, -1, d).contiguous(),
                              v.reshape(b * hkv, -1, d).contiguous(),
                              causal=causal)
        return out.reshape(b, hq, sq, d)
    if flat:
        k, v = _match_heads(k, hq), _match_heads(v, hq)
        qf = q.reshape(b * hq, sq, d).contiguous()
        kf = k.reshape(b * hq, -1, d).contiguous()
        vf = v.reshape(b * hq, -1, d).contiguous()
        if impl == "chunked":
            out = chunked_attention(qf, kf, vf, causal=causal)
        else:
            out = _ref.attention_ref(qf, kf, vf, causal=causal)
        return out.reshape(b, hq, sq, d)
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    if impl == "chunked":
        out = grouped_chunked_attention(qg, k, v, causal=causal)
    else:
        out = _grouped_ref(qg, k, v, causal)
    return out.reshape(b, hq, sq, d)


def _grouped_ref(qg, k, v, causal, lengths=None):
    """Full-softmax grouped attention. qg [B,Hkv,G,Sq,D]; k/v [B,Hkv,S,D].
    The causal mask is bottom-right aligned (``tril(k=Skv-Sq)``)."""
    d = qg.shape[-1]
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) / d ** 0.5
    sq, sk = sc.shape[-2], sc.shape[-1]
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=sc.device).tril(sk - sq)
        sc = torch.where(mask, sc, -1e30)
    if lengths is not None:
        kidx = torch.arange(sk, device=sc.device)
        sc = torch.where(kidx < lengths[:, None, None, None, None], sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()).to(qg.dtype)


def _pick_block(skv: int, block_k: int) -> int:
    block_k = min(block_k, skv)
    while skv % block_k:
        block_k -= 1          # largest divisor <= requested (worst case 1)
    return block_k


def _causal_bias(jb: int, block_k: int, sq: int, skv: int, device):
    """Additive [Sq, block_k] mask of KV block ``jb``, bottom-right
    aligned: query i sees keys up to ``i + Skv - Sq``."""
    kk = jb * block_k + torch.arange(block_k, device=device)
    qi = torch.arange(sq, device=device)
    return torch.where(kk[None, :] <= qi[:, None] + (skv - sq), 0.0, -1e30)


def _chunk_attn_fwd_impl(q, k, v, causal, block_k):
    """Online softmax over KV blocks. q [BH,Sq,D], k/v [BH,Skv,D] ->
    (out in q's dtype, lse [BH,Sq,1])."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    block_k = _pick_block(skv, block_k)
    qf = q.float()
    scale = 1.0 / (d ** 0.5)
    m = torch.full((bh, sq, 1), -1e30, device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    for jb in range(skv // block_k):
        ks = k[:, jb * block_k:(jb + 1) * block_k].float()
        vs = v[:, jb * block_k:(jb + 1) * block_k].float()
        s = torch.einsum("bqd,bkd->bqk", qf, ks) * scale
        if causal:
            s = s + _causal_bias(jb, block_k, sq, skv, q.device)[None]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p, vs)
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out, m + torch.log(l.clamp_min(1e-30))


def _chunk_attn_bwd(q, k, v, out, lse, dout, causal, block_k):
    """The flash backward over the same KV blocks, float32: ``delta =
    sum(dO·O)``, per block ``p = exp(s - lse)``, ``ds = p·(dp - delta)·
    scale``; dq accumulates, dk/dv are per block.  Returns (dq, dk, dv) in
    the inputs' dtypes."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    block_k = _pick_block(skv, block_k)
    scale = 1.0 / (d ** 0.5)
    qf = q.float()
    do = dout.float()
    delta = torch.sum(do * out.float(), -1, keepdim=True)
    dq = torch.zeros((bh, sq, d), device=q.device)
    dks, dvs = [], []
    for jb in range(skv // block_k):
        ks = k[:, jb * block_k:(jb + 1) * block_k].float()
        vs = v[:, jb * block_k:(jb + 1) * block_k].float()
        s = torch.einsum("bqd,bkd->bqk", qf, ks) * scale
        if causal:
            s = s + _causal_bias(jb, block_k, sq, skv, q.device)[None]
        p = torch.exp(s - lse)                         # [bh, sq, bk]
        dvs.append(torch.einsum("bqk,bqd->bkd", p, do))
        dp = torch.einsum("bqd,bkd->bqk", do, vs)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bqk,bkd->bqd", ds, ks)
        dks.append(torch.einsum("bqk,bqd->bkd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class _ChunkedAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, out,
    lse) and nothing of its loop; the backward is :func:`_chunk_attn_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        out, lse = _chunk_attn_fwd_impl(q, k, v, causal, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_k = causal, block_k
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*_chunk_attn_bwd(*ctx.saved_tensors, dout, ctx.causal,
                                 ctx.block_k), None, None)


def chunked_attention(q, k, v, causal: bool = True, block_k: int = 512):
    """Flash attention in plain torch with a flash backward: both passes
    loop over KV blocks and keep only (q, k, v, out, lse), O(Sq * block_k)
    memory.  q [BH, Sq, D], k/v [BH, Skv, D]; bottom-right causal mask."""
    return _ChunkedAttention.apply(q, k, v, causal, block_k)


def _gchunk_fwd_impl(qg, k, v, causal, block_k):
    b, h, g, sq, d = qg.shape
    skv = k.shape[2]
    block_k = _pick_block(skv, block_k)
    qf = qg.float()
    scale = 1.0 / (d ** 0.5)
    m = torch.full((b, h, g, sq, 1), -1e30, device=qg.device)
    l = torch.zeros((b, h, g, sq, 1), device=qg.device)
    acc = torch.zeros((b, h, g, sq, d), device=qg.device)
    for jb in range(skv // block_k):
        ks = k[:, :, jb * block_k:(jb + 1) * block_k].float()
        vs = v[:, :, jb * block_k:(jb + 1) * block_k].float()
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, ks) * scale
        if causal:
            sc = sc + _causal_bias(jb, block_k, sq, skv, qg.device)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vs)
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(qg.dtype)
    return out, m + torch.log(l.clamp_min(1e-30))


def _gchunk_bwd(qg, k, v, out, lse, dout, causal, block_k):
    """:func:`_chunk_attn_bwd` over grouped heads: dk/dv sum over the G
    query heads of each kv head."""
    b, h, g, sq, d = qg.shape
    skv = k.shape[2]
    block_k = _pick_block(skv, block_k)
    scale = 1.0 / (d ** 0.5)
    qf = qg.float()
    do = dout.float()
    delta = torch.sum(do * out.float(), -1, keepdim=True)
    dq = torch.zeros((b, h, g, sq, d), device=qg.device)
    dks, dvs = [], []
    for jb in range(skv // block_k):
        ks = k[:, :, jb * block_k:(jb + 1) * block_k].float()
        vs = v[:, :, jb * block_k:(jb + 1) * block_k].float()
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, ks) * scale
        if causal:
            sc = sc + _causal_bias(jb, block_k, sq, skv, qg.device)
        p = torch.exp(sc - lse)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, do))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vs)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, ks)
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qf))
    return (dq.to(qg.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


class _GroupedChunkedAttention(torch.autograd.Function):
    """:class:`_ChunkedAttention` over grouped heads (the reference's
    ``grouped_chunked_attention`` ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, qg, k, v, causal, block_k):
        out, lse = _gchunk_fwd_impl(qg, k, v, causal, block_k)
        ctx.save_for_backward(qg, k, v, out, lse)
        ctx.causal, ctx.block_k = causal, block_k
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*_gchunk_bwd(*ctx.saved_tensors, dout, ctx.causal,
                             ctx.block_k), None, None)


def grouped_chunked_attention(qg, k, v, causal: bool = True,
                              block_k: int = 512):
    """Flash attention over grouped heads, forward and backward: qg
    [B, Hkv, G, Sq, D]; k/v [B, Hkv, Skv, D]; kv never repeated."""
    return _GroupedChunkedAttention.apply(qg, k, v, causal, block_k)


def decode_mha(q, k, v, lengths, impl: str = "kernel"):
    """Decode attention. q [B, Hq, 1, D], k/v [B, Hkv, S, D], lengths [B].

    ``"kernel"`` folds heads into the batch for the flat
    ``decode_attention`` call: K/V as they are (query row ``r`` reads kv
    row ``r // G``), one length per kv row; any other impl runs the
    grouped full-softmax reference, as the reference's non-pallas path
    does."""
    _check_impl(impl)
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if impl == "kernel":
        lens = lengths.to(torch.int32)[:, None].expand(b, hkv).reshape(-1)
        out = decode_attention(q.reshape(b * hq, 1, d).contiguous(),
                               k.reshape(b * hkv, -1, d).contiguous(),
                               v.reshape(b * hkv, -1, d).contiguous(),
                               lens.contiguous())
        return out.reshape(b, hq, 1, d)
    qg = q.reshape(b, hkv, hq // hkv, 1, d)
    out = _grouped_ref(qg, k, v, causal=False, lengths=lengths)
    return out.reshape(b, hq, 1, d)


# ---- recurrences ----

def ssm(x, dt, a, b, c, d, h0, impl: str = "kernel"):
    """Mamba-1 selective scan. x/dt [B, S, Di]; a [Di, N]; b/c [B, S, N];
    d [Di]; h0 [B, Di, N] -> (y [B, S, Di], hT [B, Di, N]).

    ``"kernel"`` (the reference's ``"pallas"``) calls ``ssm_scan``, which
    takes float32 only; any other impl runs :func:`ssm_assoc`, as the
    reference's does."""
    if impl == "kernel":
        return ssm_scan(*(t.contiguous() for t in (x, dt, a, b, c, d, h0)))
    return ssm_assoc(x, dt, a, b, c, d, h0)


def _assoc_scan(aa: torch.Tensor, bb: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs ``(aa, bb)`` under the
    reference's combine ``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``, in
    ceil(log2 S) steps (torch has no ``associative_scan``)."""
    off = 1
    while off < aa.shape[1]:
        a_cur = aa[:, off:]
        bb = torch.cat([bb[:, :off], a_cur * bb[:, :-off] + bb[:, off:]], 1)
        aa = torch.cat([aa[:, :off], aa[:, :-off] * a_cur], 1)
        off *= 2
    return aa, bb


def _scan_block(dt, dtx, a, b, c, dx, h):
    """One block of the associative-scan formulation, all float32: dt/dtx
    (dt·x)/dx (d·x) [B, C, Di], a [Di, N], b/c [B, C, N], entering state h
    [B, Di, N] -> (y [B, C, Di], state after the block).  Materialises the
    [B, C, Di, N] pairs."""
    da = torch.exp(dt[..., None] * a)
    u = dtx[..., None] * b[:, :, None, :]
    u[:, 0] += da[:, 0] * h
    _, hh = _assoc_scan(da, u)
    return torch.einsum("bsdn,bsn->bsd", hh, c) + dx, hh[:, -1]


def ssm_assoc(x, dt, a, b, c, d, h0):
    """Associative-scan formulation over the whole sequence (the reference's
    dry-run path)."""
    f32 = torch.float32
    xf = x.to(f32)
    y, hT = _scan_block(dt.to(f32), (dt * x).to(f32), a.to(f32), b.to(f32),
                        c.to(f32), d.to(f32) * xf, h0.to(f32))
    return y.to(x.dtype), hT


def ssm_chunked(x, dt, a, b, c, d, h0, chunk: int = 128):
    """Selective scan in sequence chunks of ``chunk`` steps, carrying only
    the [B, Di, N] state between them: the [B, C, Di, N] tensors exist one
    chunk at a time.  Any S: the last chunk is just shorter (the reference
    asserts S % chunk == 0), which is exact."""
    f32 = torch.float32
    af, dsk = a.to(f32), d.to(f32)
    h = h0.to(f32)
    ys = []
    for t0 in range(0, x.shape[1], chunk):
        cut = slice(t0, t0 + chunk)
        xf, dtf = x[:, cut].to(f32), dt[:, cut].to(f32)
        y, h = _scan_block(dtf, dtf * xf, af, b[:, cut].to(f32),
                           c[:, cut].to(f32), dsk * xf, h)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, 1), h


def rg_lru_scan(a, b, h0, impl: str = "kernel"):
    """RG-LRU diagonal gated scan ``h_t = a_t·h_{t-1} + b_t``. a/b
    [B, S, D]; h0 [B, D] -> (y [B, S, D], hT [B, D]).

    ``"kernel"`` (the reference's ``"pallas"``) calls ``rg_lru``, which
    takes float32 only; any other impl runs :func:`rg_lru_assoc`, as the
    reference's does."""
    if impl == "kernel":
        return rg_lru(a.contiguous(), b.contiguous(), h0.contiguous())
    return rg_lru_assoc(a, b, h0)


def _rg_lru_block(a, b, h):
    """One block of the associative formulation, float32: a/b [B, C, D],
    entering state h [B, D] -> every state of the block [B, C, D]."""
    b = torch.cat([b[:, :1] + a[:, :1] * h[:, None], b[:, 1:]], 1)
    return _assoc_scan(a, b)[1]


def rg_lru_assoc(a, b, h0):
    """Associative scan over the whole sequence: (y in a's dtype, hT
    float32)."""
    f32 = torch.float32
    h = _rg_lru_block(a.to(f32), b.to(f32), h0.to(f32))
    return h.to(a.dtype), h[:, -1]


def rg_lru_chunked(a, b, h0, chunk: int = 256):
    """The scan in sequence chunks of ``chunk`` steps, carrying only the
    [B, D] state between them.  Any S: the last chunk is just shorter (the
    reference asserts S % chunk == 0), which is exact.  Returns (y in a's
    dtype, hT float32), the reference's cast points."""
    f32 = torch.float32
    h = h0.to(f32)
    ys = []
    for t0 in range(0, a.shape[1], chunk):
        cut = slice(t0, t0 + chunk)
        hh = _rg_lru_block(a[:, cut].to(f32), b[:, cut].to(f32), h)
        h = hh[:, -1]
        ys.append(hh.to(a.dtype))
    return torch.cat(ys, 1), h


# ---- MoE dispatch / combine ----

MOE_IMPLS = ("kernel", "scatter")


def _positions_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's running index within its expert (``flat_e`` [A]
    int64): the allocator's pointer stream, one cumsum over the one-hot
    choice (as the reference)."""
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)
    pos = torch.cumsum(onehot, 0) - onehot
    return pos.gather(1, flat_e[:, None])[:, 0]


def _combine(res: torch.Tensor, t: int, k: int, dtype) -> torch.Tensor:
    """Sum each token's ``k`` weighted expert rows ``res`` [T*K, D] (float32)
    in the tokens' dtype, in k order, rounding after every add: the
    reference's ``zeros.at[tok_of_a].add(res.astype(dtype))`` applies its
    updates one at a time in that order.  Deterministic on every device,
    where ``index_add_`` on the card adds by atomics in no fixed order."""
    res = res.to(dtype).view(t, k, -1)
    out = torch.zeros_like(res[:, 0])
    for j in range(k):
        out = out + res[:, j]
    return out


def moe_dispatch_combine(tokens, gates, expert_idx, n_experts: int,
                         capacity: int, expert_fn, impl: str = "kernel"):
    """Revet-style MoE: compaction dispatch -> ``expert_fn`` [E, C, D] ->
    weighted combine.  tokens [T, D]; gates / expert_idx [T, K] (the top-k
    router's output).  Assignments past an expert's capacity drop.

    ``"kernel"`` dispatches with :func:`moe_dispatch` (the kernel on a CUDA
    tensor, its plain version on a CPU one); ``"scatter"`` scatter-adds the
    rows, a dropped one adding zero at slot C-1, as the reference."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r} (have {MOE_IMPLS}; the "
                         "reference's 'pallas' route is 'kernel' here)")
    t, dmodel = tokens.shape
    k = expert_idx.shape[1]
    flat_e = expert_idx.reshape(-1).long()
    flat_pos = _positions_in_expert(flat_e, n_experts)
    kept = flat_pos < capacity
    slot = flat_pos.clamp(0, capacity - 1)
    gathered = tokens.repeat_interleave(k, 0)                 # [A, D]
    if impl == "kernel":
        dispatched = moe_dispatch(gathered, flat_e.to(torch.int32),
                                  flat_pos.to(torch.int32), n_experts,
                                  capacity)
    else:
        dispatched = tokens.new_zeros((n_experts, capacity, dmodel))
        dispatched.index_put_((flat_e, slot),
                              torch.where(kept[:, None], gathered, 0),
                              accumulate=True)
    # EP hint: pin the dispatch buffer to the expert-parallel layout so the
    # tokens move (all-to-all, O(T*D)) instead of the expert weights
    dispatched = _sh.act_hint(dispatched, "model", None, None)
    out_e = expert_fn(dispatched)                             # [E, C, D]
    out_e = _sh.act_hint(out_e, "model", None, None)
    res = torch.where(kept[:, None], out_e[flat_e, slot], 0) \
        * gates.reshape(-1)[:, None]
    return _combine(res, t, k, tokens.dtype)


def moe_dense_einsum(tokens, gates, expert_idx, n_experts: int,
                     capacity: int, expert_fn):
    """The MapReduce-style dense one-hot dispatch baseline (what Spatial
    could express): full [A, E, C] dispatch tensors, no compaction."""
    t, dmodel = tokens.shape
    k = expert_idx.shape[1]
    flat_e = expert_idx.reshape(-1).long()
    flat_pos = _positions_in_expert(flat_e, n_experts)
    one_hot = torch.nn.functional.one_hot
    disp = (one_hot(flat_e, n_experts).to(tokens.dtype)[:, :, None]
            * one_hot(flat_pos.clamp(0, capacity - 1), capacity)
            .to(tokens.dtype)[:, None, :])
    disp = disp * (flat_pos < capacity)[:, None, None].to(tokens.dtype)
    gathered = tokens.repeat_interleave(k, 0)
    dispatched = torch.einsum("aec,ad->ecd", disp, gathered)
    out_e = expert_fn(dispatched)
    res = torch.einsum("aec,ecd->ad", disp, out_e) \
        * gates.reshape(-1)[:, None]
    return _combine(res, t, k, tokens.dtype)

"""decode_attention — one query per row over a KV cache, masked by each
kv row's valid length, written by hand for Hopper.

On a CUDA tensor :func:`decode_attention` launches
``csrc/decode_attention.cu`` (which replaces the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``); on a CPU tensor it
runs :func:`decode_attention_plain`, the same function in plain torch.
There is no fallback from one to the other.

GQA is by index: q holds BHq query rows, k/v and lengths BHkv kv rows, and
the G = BHq // BHkv query rows ``r*G .. r*G + G-1`` read kv row ``r`` and
share its length (``ops.decode_mha`` passes its K/V as they are).

The kernel splits each kv row's keys into ``n_split`` chunks of
``ceil(S / n_split)`` keys (:func:`split_plan` picks ``n_split`` so that
the grid fills the card; a row's valid length cuts its chunks short).
One block takes one (kv row, chunk) for all G query rows of that kv row,
reading each K/V element once, and writes each query row's partial
softmax state ``(m, l, acc[D])`` in float32; a second kernel merges the
chunks of each query row (skipped when ``n_split == 1``).  A call is
therefore one or two device kernels, counted as one launch.  In bfloat16
with 2 <= G <= 16 the block runs the G query rows as one m16 tile on the
tensor cores (P as two bf16 terms, hi V + lo V, as in flash, so that P V
keeps the reference's float32 P); otherwise lane groups of scalar FMAs
keep ``kH`` query rows each.

Bound: bytes — each kv row's K and V up to its valid length, plus q and
the output per query row and the lengths, at 3.35 TB/s on an H100 SXM;
the kernel does 4*D*G flops per key.  Unlike the reference kernel, any S
is taken (the reference asserts whole 512-key blocks).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import HEAD_DIMS, NEG_INF, _DTYPES

H100_SMS = 132
MIN_CHUNK = 256          # keys per chunk, at least (S permitting)
_THREADS = 256           # threads of a split block (csrc: kBlock)
_MAX_HEADS_PER_GROUP = 2  # csrc: the largest kH instance
_MAX_BHKV = 65535        # grid.y


def _check(q, k, v, lengths) -> int:
    """Validate the grouped contract; returns G = BHq // BHkv."""
    if q.dim() != 3 or q.shape[1] != 1 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("decode_attention: want q [BHq, 1, D] and k/v "
                         f"[BHkv, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bhq, _, d = q.shape
    bhkv = k.shape[0]
    if k.shape[2] != d or k.shape[1] < 1 or bhkv < 1:
        raise ValueError("decode_attention: k/v must be [BHkv >= 1, S >= 1, "
                         f"D] like q {tuple(q.shape)}, got {tuple(k.shape)}")
    if bhq % bhkv:
        raise ValueError(f"decode_attention: BHq = {bhq} is not a multiple "
                         f"of BHkv = {bhkv} (query row r reads kv row "
                         "r // (BHq // BHkv))")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k, v must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (bhkv,):
        raise TypeError("decode_attention: lengths must be int32 [BHkv], got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("decode_attention: inputs on different devices")
    return bhq // bhkv


def _scores(q, k, lengths, g):
    """[BHkv, G, S] float32 scores, keys at or past each kv row's length
    at -1e30 (a length <= 0 masks every key)."""
    bhkv, s_len, d = k.shape
    qg = q.float().reshape(bhkv, g, d)
    s = torch.einsum("bgd,bkd->bgk", qg, k.float()) * (1.0 / d ** 0.5)
    kidx = torch.arange(s_len, device=q.device)
    return torch.where(kidx[None, None, :] < lengths[:, None, None], s,
                       NEG_INF)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: full softmax in
    float32, keys at or past each kv row's length scored -1e30."""
    g = _check(q, k, v, lengths)
    s = _scores(q, k, lengths, g)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bgk,bkd->bgd", p, v.float())
    out = acc / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, lengths: torch.Tensor,
                                 n_split: int) -> torch.Tensor:
    """The kernel's split arithmetic in plain torch: each chunk of
    ``ceil(S / n_split)`` keys keeps its own ``(m, l, acc)`` over the keys
    it holds (a length past S means all S keys; a length <= 0 scores all S
    keys -1e30; keys past the valid ones are not in any chunk), and the
    chunks merge as the combine kernel does:
    ``M = max m_c``, ``w_c = exp(m_c - M)``,
    ``out = sum(w_c acc_c) / max(sum(w_c l_c), 1e-30)``.
    A chunk with no keys is ``(-1e30, 0, 0)``."""
    g = _check(q, k, v, lengths)
    s_len = k.shape[1]
    _check_split(n_split, s_len)
    chunk = -(-s_len // n_split)
    s = _scores(q, k, lengths, g)                       # [BHkv, G, S]
    kidx = torch.arange(s_len, device=q.device)
    n_keys = torch.where(lengths <= 0, s_len, lengths.clamp(max=s_len))
    held = kidx[None, :] < n_keys[:, None]              # [BHkv, S]
    bhkv, d = k.shape[0], k.shape[2]
    ms, ls, accs = [], [], []
    for c in range(n_split):
        sl = slice(c * chunk, min((c + 1) * chunk, s_len))
        if sl.start >= s_len:                            # an empty chunk
            ms.append(torch.full((bhkv, g, 1), NEG_INF, device=q.device))
            ls.append(torch.zeros(bhkv, g, 1, device=q.device))
            accs.append(torch.zeros(bhkv, g, d, device=q.device))
            continue
        inc = held[:, None, sl]
        sc = torch.where(inc, s[:, :, sl], NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(inc, torch.exp(sc - m), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bgk,bkd->bgd", p, v[:, sl].float()))
    m = torch.stack(ms)                                  # [C, BHkv, G, 1]
    w = torch.exp(m - m.amax(0))
    lsum = (w * torch.stack(ls)).sum(0)
    out = (w * torch.stack(accs)).sum(0) / lsum.clamp_min(1e-30)
    return out.reshape(q.shape).to(q.dtype)


def _check_split(n_split: int, s_len: int) -> None:
    if not 1 <= n_split <= s_len:
        raise ValueError(f"decode_attention: n_split = {n_split} must lie "
                         f"in [1, S = {s_len}]")


def split_plan(bhkv: int, s_len: int) -> int:
    """Chunks per kv row: enough blocks to fill two waves of the card's
    SMs (``BHkv * n_split >= 2 * 132``), each chunk at least
    ``MIN_CHUNK`` keys (one chunk when S is shorter)."""
    want = -(-2 * H100_SMS // bhkv)
    return max(1, min(want, s_len // MIN_CHUNK))


def _heads_per_group(d: int, g: int) -> int:
    """The lane-group kernel's kH instance (the tensor-core kernel ignores
    it): a block holds ``2048 // D`` lane groups (D/8 lanes each), and each
    group keeps up to kH of the G query rows in registers."""
    groups = _THREADS // (d // 8)
    need = -(-g // groups)
    for kh in (1, _MAX_HEADS_PER_GROUP):
        if need <= kh:
            return kh
    raise ValueError(f"decode_attention: G = {g} query rows per kv row "
                     f"exceeds {_MAX_HEADS_PER_GROUP * groups} at head dim "
                     f"{d}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = (
        [p] * 7 + [i] * 7 + [ctypes.c_float, p])
    lib.decode_attention_launch.restype = ctypes.c_int
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q [BHq, 1, D], k/v [BHkv, S, D], lengths [BHkv] int32 (BHq a
    multiple of BHkv) -> out [BHq, 1, D] in q's dtype.

    A CUDA tensor launches the kernel with :func:`split_plan` chunks per kv
    row (raising if it cannot: head dim not in ``HEAD_DIMS``,
    non-contiguous or misaligned input), a CPU tensor runs
    :func:`decode_attention_plain`."""
    _build.refuse_grad("decode_attention", q, k, v)
    g = _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    out = _launch(q, k, v, lengths, g, split_plan(k.shape[0], k.shape[1]))
    decode_attention.launches += 1
    return out


def _launch(q, k, v, lengths, g: int, n_split: int):
    """Launch the kernel on checked inputs with ``n_split`` chunks per kv
    row, raising if the launch fails.  Counts nothing:
    :func:`decode_attention` does."""
    bhq, _, d = q.shape
    bhkv, s_len = k.shape[0], k.shape[1]
    _check_split(n_split, s_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} has no kernel "
                         f"instance (have {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if bhkv > _MAX_BHKV:
        raise ValueError(f"decode_attention: BHkv = {bhkv} exceeds "
                         f"{_MAX_BHKV}")
    kh = _heads_per_group(d, g)
    lib = _lib()
    out = torch.empty_like(q)
    ml_ptr = acc_ptr = None
    if n_split > 1:      # float32 (m, l), then acc[D], per (query row, chunk)
        parts = torch.empty(bhq * n_split * (d + 2), dtype=torch.float32,
                            device=q.device)
        ml_ptr = parts.data_ptr()
        acc_ptr = ml_ptr + 4 * 2 * bhq * n_split
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ml_ptr, acc_ptr, bhkv, g, s_len, d,
            _DTYPES[q.dtype], n_split, kh, 1.0 / d ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "decode_attention", err)
    return out


#: wrapper calls that reached the card (one per call, though a call with
#: more than one chunk runs two device kernels); the plain path does not
#: count
decode_attention.launches = 0

"""Continuous-batching decode engine — the paper's forward-backward merge
(§III-B(d)) running an LLM serving loop (DESIGN.md §2).

The decode loop is a circulating while-loop over request *threads*:

* **forward branch** — queued requests are admitted into free batch slots
  (the merge takes from the forward link whenever a lane is free);
* **backedge** — active slots recirculate every step with one new token;
* **exit filter** — slots whose thread hits EOS / max-tokens are filtered
  out, and their KV slot (the hoisted allocator's buffer, §V-B(b)) returns
  to the free list, which is what admits the next request — the same
  allocator feedback loop as Fig. 14's load balancing.

Slot state is dense (lane-compacted): the batch dimension is always fully
occupied by live threads + explicitly-masked free lanes, never by divergent
finished threads — the dataflow-threads claim, applied to serving.

The engine runs eagerly on one torch device (``None``: the card).  Its
default attention is ``impl="kernel"``, so prefill goes through the
hand-written flash attention kernel on a CUDA device; the reference's
default is ``"naive"``.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..models.params import leaves, resolve_device
from ..models.zoo import Zoo

EOS = 0

# per-cache-leaf batch axis (mirrors the reference's sharding._CACHE_LAYOUT)
_BATCH_AXIS = {"k": 1, "v": 1, "xk": 1, "xv": 1, "attn_k": 1, "attn_v": 1,
               "h": 1, "conv": 1, "rec_h": 2, "rec_conv": 2,
               "tail_h": 1, "tail_conv": 1}


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int = 32
    tokens: list[int] = field(default_factory=list)
    done: bool = False


class DecodeEngine:
    def __init__(self, zoo: Zoo, params, batch_slots: int, max_len: int,
                 impl: str = "kernel", device=None):
        dev = resolve_device(device, "DecodeEngine")
        wrong = {t.device for t in leaves(params) if t.device.type != dev.type}
        if wrong:
            raise ValueError(f"DecodeEngine on {dev}: params live on "
                             f"{sorted(map(str, wrong))}")
        self.zoo = zoo
        self.params = params
        self.device = dev
        self.b = batch_slots
        self.max_len = max_len
        self.impl = impl
        self.cache = zoo.init_cache(batch_slots, max_len, device=dev)
        self.position = torch.zeros((batch_slots,), dtype=torch.int32,
                                    device=dev)
        self.last_tok = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                    device=dev)
        self.slot_req: list[Optional[Request]] = [None] * batch_slots
        self.free = collections.deque(range(batch_slots))   # allocator queue
        self.queue: collections.deque[Request] = collections.deque()
        self.steps = 0
        self.occupancy: list[int] = []

    # -- forward link ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        """Forward merge: move queued requests into free lanes (prefill the
        prompt at batch=1 and splice its cache into the slot)."""
        while self.queue and self.free:
            slot = self.free.popleft()
            req = self.queue.popleft()
            toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                   device=self.device)[None]
            with tracing.span("engine.prefill", req.rid, device=True):
                lg, cache1, pos1 = self.zoo.prefill(
                    self.params, {"tokens": toks}, self.max_len,
                    impl=self.impl)
            with tracing.span("engine.splice", req.rid, device=True):
                self.cache = _splice_cache(self.cache, cache1, slot)
            first = int(torch.argmax(lg[0, -1]))
            self.last_tok[slot, 0] = first
            self.position[slot] = pos1[0]
            req.tokens.append(first)
            self.slot_req[slot] = req

    # -- one circulation --------------------------------------------------------
    def step(self) -> None:
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        self.occupancy.append(len(active))
        if not active:
            return
        with tracing.span("engine.decode", device=True):
            lg, self.cache, self.position = self.zoo.decode_step(
                self.params, self.last_tok, self.cache, self.position)
        nxt = torch.argmax(lg[:, 0], -1).to(torch.int32)
        self.last_tok = nxt[:, None]
        nxt_np = nxt.cpu().numpy()
        pos_np = self.position.cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            tok = int(nxt_np[i])
            req.tokens.append(tok)
            # exit filter: EOS or budget exhausted -> free the lane
            if tok == EOS or len(req.tokens) >= req.max_new \
                    or int(pos_np[i]) >= self.max_len - 1:
                req.done = True
                self.slot_req[i] = None
                self.free.append(i)          # allocator feedback (Fig. 14)
        self.steps += 1

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        """Step until no request is queued or active.  Returns an empty
        list, as the reference does (it never fills it): read each
        request's ``done`` and ``tokens``."""
        finished: list[Request] = []
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return finished

    def stats(self) -> dict:
        occ = self.occupancy or [0]
        return {"steps": self.steps,
                "mean_occupancy": float(np.mean(occ)),
                "peak_occupancy": int(np.max(occ))}


def _splice_cache(batch_cache, single_cache, slot: int):
    """Insert a prefilled batch=1 cache into lane ``slot`` (a new cache).

    As ``lax.dynamic_update_slice_in_dim`` does in the reference, a source
    shorter than the slot along another axis (a hybrid's K/V window of a
    prompt shorter than the ring, a conv tail of a prompt shorter than
    K-1) fills the leading sub-block of the slot and leaves the rest as it
    was; a longer one raises."""
    out = {}
    for k, v in batch_cache.items():
        ax = _BATCH_AXIS[k]
        src = single_cache[k]
        dst = v.narrow(ax, slot, 1)
        if src.dim() != v.dim() or src.shape[ax] != 1 or any(
                n > m for n, m in zip(src.shape, dst.shape)):
            raise ValueError(f"_splice_cache: {k!r} of shape "
                             f"{tuple(src.shape)} does not fit a slot of "
                             f"{tuple(dst.shape)}")
        o = v.clone()
        dst = o.narrow(ax, slot, 1)
        for axis, n in enumerate(src.shape):
            dst = dst.narrow(axis, 0, n)
        dst.copy_(src.to(v.dtype))
        out[k] = o
    return out

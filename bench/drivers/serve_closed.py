"""Closed-loop serving through ``repro_torch.serve.engine.DecodeEngine``.

One client per slot sends its next request when its last one finishes,
with no think time.  Set-up draws the weights, builds the engine
(``impl="kernel"``), prefills one prompt at the longest size the traffic
holds, then fills every slot; the first requests' output budgets are drawn
from their residual life (uniform up to the drawn ``max_new``) so that
slots finish at spread-out steps, and a few more steps run before the
window opens at a step boundary.  The window steps the engine until
``--seconds`` have passed.

Times are taken at the end of each ``step()``: a token is delivered when
the step that produced it returns; a request is submitted at the end of
the step that finished its client's previous one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import correct, measure, model, spec, traffic
from ..context import Profiled
from ..reference.common import Precision


@dataclass
class Rec:
    req: object
    submit: float
    prompt: np.ndarray
    times: list = field(default_factory=list)

    @property
    def served(self) -> list:
        return self.req.tokens


def _timed_zoo(zoo, ctx, rec: dict):
    """``zoo`` whose prefill and decode_step are synchronised host-clock
    spans inside profiler ranges, recorded while ``rec["on"]``."""
    from repro_torch.models.zoo import Zoo

    class TimedZoo(Zoo):
        def prefill(self, params, batch, max_len, impl="chunked"):
            ctx.sync()
            t = time.perf_counter()
            with torch.profiler.record_function("prefill"):
                out = super().prefill(params, batch, max_len, impl=impl)
                ctx.sync()
            if rec["on"]:
                rec["prefill"].append(((time.perf_counter() - t) * 1e3,
                                       int(batch["tokens"].shape[1])))
            return out

        def decode_step(self, *a, **kw):
            ctx.sync()
            t = time.perf_counter()
            with torch.profiler.record_function("decode_step"):
                out = super().decode_step(*a, **kw)
                ctx.sync()
            if rec["on"]:
                rec["decode_ms"].append((time.perf_counter() - t) * 1e3)
            return out

    return TimedZoo(zoo.cfg, zoo.mod)


def _fault(eng, kind: str) -> None:
    """Tests only: break the timed path underneath the harness."""
    if kind == "token":           # a token altered where it is produced
        step = eng.step

        def altered():
            step()
            for r in eng.slot_req:
                if r is not None and len(r.tokens) > 1:
                    r.tokens[-1] = (r.tokens[-1] + 1) % eng.zoo.cfg.vocab
        eng.step = altered
    elif kind == "stale_state":   # decode returns its cache unchanged
        dec = eng.zoo.decode_step

        def stale(params, token, cache, position):
            lg, _, pos = dec(params, token, cache, position)
            return lg, cache, pos
        eng.zoo.decode_step = stale
    elif kind:
        raise ValueError(f"unknown fault {kind!r}")


def run(ctx) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.models.zoo import get_model
    from repro_torch.serve.engine import DecodeEngine, Request

    ctx.log("port imported")
    cell, cfg = ctx.cell, ctx.cfg
    slots, max_len = cell["slots"], cell["max_len"]
    stream = traffic.Stream(cell["prompt"], cell["output"],
                            cfg["vocab_size"], ctx.seed)
    zoo = get_model(model.port_config(cfg))
    model.check_layout(cfg, zoo)
    w = model.draw_weights(cfg, ctx.seed, ctx.device)
    params = model.as_tree(w)
    rec = {"on": False, "prefill": [], "decode_ms": [], "flash": []}
    patches = measure.Patches()
    if ctx.trace:
        zoo = _timed_zoo(zoo, ctx, rec)
        patches.set(ops, "flash_attention", measure.event_timed_flash(
            ops.flash_attention, rec))
        patches.set(ops, "moe_dispatch_combine", measure.ranged(
            ops.moe_dispatch_combine, "moe_dispatch"))
    eng = DecodeEngine(zoo, params, slots, max_len, impl="kernel",
                       device=ctx.device)
    _fault(eng, ctx.fault)
    ctx.log(f"weights drawn, engine of {slots} slots x {max_len}")

    # warm-up: the longest prompt the traffic holds, then every slot
    zoo.prefill(params, {"tokens": torch.as_tensor(
        stream.warm_ids(cell["prompt"]["hi"]), device=ctx.device)[None]},
        max_len, impl="kernel")
    ctx.sync()
    ctx.log("longest prompt prefilled")
    recs: list[Rec] = []
    live: dict[int, Rec] = {}
    next_id = [0]

    def submit(now: float, residual: bool = False) -> None:
        i = next_id[0]
        next_id[0] += 1
        prompt, max_new = stream.request(i)
        if residual:
            max_new = stream.residual(i, max_new)
        r = Rec(Request(rid=i, prompt=prompt, max_new=max_new), now, prompt)
        recs.append(r)
        live[i] = r
        eng.submit(r.req)

    def step() -> float:
        eng.step()
        now = time.perf_counter()
        for i, r in list(live.items()):
            new = len(r.req.tokens) - len(r.times)
            r.times.extend([now] * new)
            if r.req.done:
                del live[i]
                submit(now)
        return now

    now = time.perf_counter()
    for _ in range(slots):
        submit(now, residual=True)
    for _ in range(cell["warm_steps"]):
        step()
    ctx.sync()

    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"slots filled, {cell['warm_steps']} steps run: window opens")
    occ0 = len(eng.occupancy)
    rec["on"] = True
    t0 = t_end = time.perf_counter()
    while t_end - t0 < ctx.seconds:
        t_end = step()
    rec["on"] = False
    window = t_end - t0
    occupancy = eng.occupancy[occ0:]
    peak = ctx.memory_peak()
    ctx.log(f"window {window:.3f} s, {len(recs)} requests so far")

    # the window's numbers
    tokens, ttft, itl = 0, [], []
    for r in recs:
        inside = [t for t in r.times if t0 < t <= t_end]
        tokens += len(inside)
        if r.times and t0 < r.times[0] <= t_end:
            ttft.append((r.times[0] - r.submit) * 1e3)
        itl += [(b - a) * 1e3 for a, b in zip(r.times, r.times[1:])
                if a >= t0 and b <= t_end]
    finished = [r for r in recs if r.req.done and r.times
                and t0 < r.times[-1] <= t_end]
    e2e = {"output_tokens_per_s": tokens / window,
           "ttft_p90_ms": measure.percentile(ttft, 90),
           "itl_p95_ms": measure.percentile(itl, 95),
           "setup_s": setup_s}
    out = {"e2e": e2e, "setup_s": setup_s, "memory_peak_bytes": peak,
           "window_s": window,
           "counts": {"requests_first_token": len(ttft),
                      "requests_finished": len(finished),
                      "tokens": tokens, "gaps": len(itl),
                      "steps": len(occupancy)}}
    if ctx.trace:
        # the profiled slice: the same steady serving, right after the
        # window, so that the profiler's own cost stays out of the spans
        prof = Profiled(ctx, ranges=("prefill", "moe_dispatch"))
        prof.start()
        t = time.perf_counter()
        while time.perf_counter() - t < cell["profile_seconds"]:
            step()
        prof.stop()
        flash = [(s.elapsed_time(e), *shape) for s, e, *shape in rec["flash"]]
        out["trace"] = {"cfg": cfg, "slots": slots, "occupancy": occupancy,
                        "prefill": rec["prefill"],
                        "decode_ms": rec["decode_ms"], "flash": flash,
                        "ttft_ms": ttft, "itl_ms": itl,
                        "profile": prof.result()}
    patches.close()

    # correctness, once the window has closed and the engine is freed
    del eng
    ctx.free()
    check = cell["check"]
    picked = correct.sample(finished, ctx.seed, check["tokens"],
                            lambda r: len(r.prompt) + len(r.served))
    per_req = [correct.gaps(lg, finished[i].served).cpu()
               for i, lg in zip(picked, reference_logits(ctx, w, finished,
                                                         picked))]
    ctx.log(f"checked {len(picked)} requests")
    allg = torch.cat(per_req) if per_req else torch.full((1,), float("inf"))
    got = {"max_logit_gap": float(allg.max()),
           "mean_logit_gap": float(allg.mean())}
    n_tok = int(allg.numel()) if per_req else 0
    out["attempted"] = len(finished)
    out["failed"] = 0
    out["checks"] = [{"name": k, "value": got[k], "limit": check[k],
                      "ok": got[k] <= check[k]}
                     for k in ("max_logit_gap", "mean_logit_gap")
                     if k in check]
    out["checks"].append(
        {"name": "tokens_checked", "value": n_tok, "limit": check["tokens"],
         "ok": n_tok >= min(check["tokens"],
                            sum(len(r.served) for r in finished))
         and n_tok > 0})
    out["readings"] = got
    if ctx.notes.get("keep"):          # the control's readings reuse them
        ctx.notes.update(weights=w, finished=finished, picked=picked)
    out["sample"] = [{"prompt": len(finished[i].prompt),
                      "served": len(finished[i].served),
                      "widest": float(g.max()), "mean": float(g.mean())}
                     for i, g in zip(picked, per_req)]
    return out


def reference_logits(ctx, w, finished, picked, prec=Precision()):
    """The reference's logits at the served positions of each picked
    request, one request at a time (TF32 off)."""
    ref = spec.reference(ctx.cfg["family"])
    with measure.no_tf32():
        for i in picked:
            r = finished[i]
            yield correct.served_logits(ref, w, ctx.cfg, r.prompt, r.served,
                                        ctx.device, prec)


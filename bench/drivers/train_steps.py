"""Training steps through ``repro_torch.launch.train.build_step``.

Set-up draws the weights, builds one step (its model, AdamW state and
feed) and drives it through the first ``check.steps`` steps, reading what
the check compares: each step's loss, the first gradient as the optimizer
got it (its first moment over 1 - b1) and the parameters' change over
those steps.  That same state goes on into the window, which runs whole
steps, each on rows that no other step had, until ``--seconds`` have
passed.  The reference follows the first steps once the window has closed.
"""
from __future__ import annotations

import time

import torch

from .. import correct, measure, model, traffic
from ..context import Profiled
from ..reference import train as ref_train


def _fault(kind: str, step, train_mod, patches):
    """Tests and the fault readings only: break the timed path."""
    if kind == "stale_state":           # a step returns its state unchanged
        def stale(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return stale
    if kind == "half_batch":            # half the rows, the mean over them
        inner = train_mod.loss_and_grads

        def half(zoo, params, batch, impl="chunked"):
            rows = batch["tokens"].shape[0] // 2
            return inner(zoo, params, {"tokens": batch["tokens"][:rows]},
                         impl)
        patches.set(train_mod, "loss_and_grads", half)
        return step
    if kind:
        raise ValueError(f"unknown fault {kind!r}")
    return step


def run(ctx) -> dict:
    from repro_torch.launch import train
    from repro_torch.models.zoo import get_model
    from repro_torch.optim import adamw

    ctx.log("port imported")
    cell, cfg = ctx.cell, ctx.cfg
    b, s = cell["batch"], cell["seq_len"]
    check = cell["check"]
    zoo = get_model(model.port_config(cfg))
    model.check_layout(cfg, zoo)
    w = model.draw_weights(cfg, ctx.seed, ctx.device)
    params = model.as_tree(w)
    ocfg = adamw.OptConfig(**cell["opt"])
    state = {"params": params, "opt": adamw.init_state(params)}
    del params
    patches = measure.Patches()
    rec = {"loss_grads_ms": [], "optim_ms": []}
    if ctx.trace:
        patches.set(train, "loss_and_grads", measure.synced_span(
            train.loss_and_grads, rec["loss_grads_ms"], ctx.sync,
            "loss_and_grads"))
        patches.set(adamw, "apply", measure.synced_span(
            adamw.apply, rec["optim_ms"], ctx.sync, "adamw"))
    step = _fault(ctx.fault, train.build_step(zoo, ocfg, "chunked", None),
                  train, patches)

    def rows(i: int) -> torch.Tensor:
        return torch.as_tensor(traffic.packed_rows(
            ctx.seed, i, b, s, cfg["vocab_size"], cell["documents"]),
            device=ctx.device)

    ctx.sync()
    ctx.log("weights drawn, step built")

    # the first steps, read for the check (set-up)
    prog = {"loss": [], "grad": {}, "grads": {}, "change": {}}
    for i in range(check["steps"]):
        state, metrics = step(state, {"tokens": rows(i)})
        prog["loss"].append(float(metrics["loss"]))
        ctx.log(f"set-up step {i} done")
        if i == 0:
            for k, m in model.flatten(state["opt"]["m"]).items():
                # the norm on the card: a float32 norm of 1e8 values on
                # the host is off by percents
                prog["grad"][k] = float(torch.linalg.vector_norm(m)) \
                    / (1 - ocfg.b1)
                prog["grads"][k] = (m / (1 - ocfg.b1)).cpu()
            w = {k: t.cpu() for k, t in w.items()}    # the reference's start
    for k, t in model.flatten(state["params"]).items():
        prog["change"][k] = float(torch.linalg.vector_norm(
            t.float() - w[k].to(ctx.device).float()))
    for k in rec:
        rec[k].clear()
    ctx.sync()

    setup_s = time.perf_counter() - ctx.t0
    times = []
    t0 = t_end = time.perf_counter()
    i = check["steps"]
    while t_end - t0 < ctx.seconds:
        state, _ = step(state, {"tokens": rows(i)})
        ctx.sync()
        now = time.perf_counter()
        times.append(now - t_end)
        t_end = now
        i += 1
    window = t_end - t0
    peak = ctx.memory_peak()
    if ctx.trace:
        # the profiled slice: steps right after the window, so that the
        # profiler's own cost stays out of the spans
        spans = {k: list(v) for k, v in rec.items()}
        prof = Profiled(ctx)
        prof.start()
        for _ in range(cell["profile_steps"]):
            state, _ = step(state, {"tokens": rows(i)})
            i += 1
        prof.stop()
        rec.update(spans)
        trace_profile = prof.result()
    patches.close()
    ctx.log(f"window {window:.3f} s, {len(times)} steps")
    out = {"e2e": {"train_tokens_per_s": b * s * len(times) / window,
                   "setup_s": setup_s},
           "setup_s": setup_s, "memory_peak_bytes": peak, "window_s": window,
           "counts": {"steps": len(times), "tokens_per_step": b * s}}
    if ctx.trace:
        out["trace"] = {"cfg": cfg, "seq_len": s, "tokens_per_step": b * s,
                        "step_s": times, **rec, "profile": trace_profile}

    # the reference follows the first steps
    del state
    ctx.free()
    with measure.no_tf32():
        ref = ref_train.follow(w, cfg, [rows(j) for j in range(check["steps"])],
                               cell["opt"], ctx.device)
    nums = correct.train_numbers(prog, ref, check["min_grad_share"])
    out["attempted"] = check["steps"]
    out["failed"] = 0
    out["checks"] = [{"name": k, "value": nums[k], "limit": check[k],
                      "ok": nums[k] <= check[k]}
                     for k in ("loss", "grad", "direction", "change")
                     if k in check]
    out["sample"] = {k: {"loss": d["loss"], "grad": d["grad"],
                         "change": d["change"]}
                     for k, d in (("program", prog), ("reference", ref))}
    out["sample"]["worst"] = {k: nums[k] for k in ("grad_leaf",
                                                   "direction_leaf",
                                                   "change_leaf", "left_out")}
    return out

"""End-to-end training driver, on the card unless the caller asks for the
CPU.

Composes the stack: the synthetic data pipeline, one eager train step (loss
-> grads -> optional int8 error-feedback gradient compression -> AdamW), and
the fault-tolerant supervisor (checkpoint/restart, straggler monitor,
preemption guard).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --preset reduced --steps 100 --batch 8 --seq 128

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu ...

``--simulate-fault N`` raises a simulated fault at step N (once) to drive
the restart path end to end: the supervisor restores the latest checkpoint
onto the run's device and replays from there; the pipeline is counter-based,
so the replayed steps see the same batches.  The step differentiates the
family's ``loss_fn`` with ``impl="chunked"`` by default (the attention's and
the cross-entropy's flash backwards, the plain scans); the hand-written
kernels have no backward and refuse to run under grad.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .. import tracing
from ..configs import get_config, get_reduced
from ..data.pipeline import DataConfig, Pipeline
from ..distributed.fault_tolerance import (PreemptionGuard, SimulatedFault,
                                           Supervisor)
from ..models.params import leaves, resolve_device, unflatten
from ..models.zoo import get_model
from ..optim import adamw, compression


def loss_and_grads(zoo, params, batch, impl: str = "chunked"):
    """(loss, grads): ``zoo.loss_fn`` on a detached ``requires_grad`` view
    of every param leaf, differentiated by ``torch.autograd.grad``; a leaf
    the loss does not reach gets zeros, as ``jax.grad`` gives.  The grads
    have the params' structure and dtypes."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = zoo.loss_fn(unflatten(params, flat), batch, impl=impl)
        with tracing.span("train.backward", device=True):
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def build_step(zoo, ocfg, impl: str, grad_compression: str | None):
    """``step(state, batch) -> (new state, {"loss", "lr", "grad_norm"})``
    over ``state = {"params", "opt"[, "err"]}``; eager, no compilation."""
    def step(state, batch):
        params, opt, err = state["params"], state["opt"], state.get("err")
        loss, grads = loss_and_grads(zoo, params, batch, impl)
        if grad_compression == "int8":
            grads, err = compression.roundtrip_tree(grads, err)
        params, opt, metrics = adamw.apply(params, grads, opt, ocfg)
        out = {"params": params, "opt": opt}
        if err is not None:
            out["err"] = err
        return out, {"loss": loss, **metrics}

    return step


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--impl", default="chunked")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8"])
    ap.add_argument("--simulate-fault", type=int, default=None)
    ap.add_argument("--preempt-flag", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(device if device is not None else args.device,
                         "launch.train")
    cfg = get_reduced(args.arch) if args.preset == "reduced" \
        else get_config(args.arch)
    zoo = get_model(cfg)
    ocfg = adamw.OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                           total_steps=args.steps)
    data = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch))

    params = zoo.init_params(0, device=dev)
    state = {"params": params, "opt": adamw.init_state(params)}
    if args.grad_compression == "int8":
        state["err"] = compression.init_error_state(params)
    step_eager = build_step(zoo, ocfg, args.impl, args.grad_compression)

    losses: list[float] = []
    faulted = {"done": False}

    def step_fn(state, step):
        if args.simulate_fault is not None and step == args.simulate_fault \
                and not faulted["done"]:
            faulted["done"] = True
            raise SimulatedFault(f"injected at step {step}")
        batch = data.batch(step, dev)
        if cfg.family == "vlm":
            rng = np.random.default_rng(step)
            batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (args.batch, cfg.n_patches, cfg.vit_width))
            ).to(torch.bfloat16).to(dev)
        if cfg.family == "encdec":
            rng = np.random.default_rng(step)
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (args.batch, min(args.seq, 4096), 80))
            ).to(torch.float32).to(dev)
        state, metrics = step_eager(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        return state

    sup = Supervisor(args.ckpt_dir, ckpt_every=args.ckpt_every,
                     preemption=PreemptionGuard(args.preempt_flag)
                     if args.preempt_flag else None)
    t0 = time.time()
    state, stopped = sup.run(state, step_fn, args.steps, devices=dev)
    dt = time.time() - t0
    tok_s = args.batch * args.seq * len(losses) / max(dt, 1e-9)
    print(f"done: {stopped} steps, {dt:.1f}s, {tok_s:.0f} tok/s, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"restarts={sup.restarts}")
    for line in sup.log:
        print("  [supervisor]", line)
    return {"losses": losses, "restarts": sup.restarts, "stopped": stopped,
            "tok_s": tok_s}


if __name__ == "__main__":
    main()

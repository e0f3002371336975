"""Serving entry point: continuous-batching decode engine under a synthetic
request load (mixed prompt/output lengths), on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --preset full --requests 8 --slots 4

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b

Reports throughput and lane occupancy — the serving analogue of the paper's
lane-density claim (the engine IS the forward-backward merge; see
serve/engine.py).  ``--arch`` takes any architecture of a ported family
(dense, moe, ssm, hybrid).  The engine runs its default ``impl="kernel"``:
a dense or MoE model's prefill attention goes through the hand-written
flash attention kernel, and an MoE layer's tokens reach its experts through
the reference's scatter dispatch (``moe_ff``'s served route; the dispatch
kernel is ``ops.moe_dispatch_combine(impl="kernel")``); an SSM's prefill
runs the reference's plain chunked scan whatever the impl, so its state
carries over constant-size into the decode steps; a hybrid's prefill runs
flash in its local-attention blocks (the banded plain path past the window)
and the plain chunked RG-LRU scan in its recurrent blocks, as the
reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..models.params import resolve_device
from ..models.zoo import get_model
from ..serve.engine import DecodeEngine, Request


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="reduced")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device, "launch.serve")
    cfg = get_reduced(args.arch) if args.preset == "reduced" \
        else get_config(args.arch)
    zoo = get_model(cfg)
    params = zoo.init_params(0, device=dev)
    eng = DecodeEngine(zoo, params, batch_slots=args.slots,
                       max_len=args.max_len, device=dev)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab,
                                        size=int(rng.integers(4, 17))),
                    max_new=int(rng.integers(4, args.max_new + 1)))
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)

    t0 = time.time()
    eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total_new = sum(len(r.tokens) for r in reqs)
    st = eng.stats()
    print(f"served {len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s)")
    print(f"decode steps: {st['steps']}, mean lane occupancy "
          f"{st['mean_occupancy']:.2f}/{args.slots}, "
          f"peak {st['peak_occupancy']}")
    if not all(r.done for r in reqs):
        raise RuntimeError("launch.serve: a request did not finish")
    return {"tokens": total_new, "dt": dt, **st}


if __name__ == "__main__":
    main()

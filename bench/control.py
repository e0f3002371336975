#!/usr/bin/env python3
"""The readings that set each cell's limits: the program's, the control's
and the faults', on the card at the cell's own size.  The benchmark's own
runs do not run this.

    python bench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds 15]

Serving cells: a short window at the cell's load per seed, then on the
window's sample the widest gap of the program's served tokens and of the
tokens that the reference computed at float8 e4m3 (the control) puts
first, both against the float32 reference.  Training cells: per seed the
program's numbers, the control's (the float8 reference in the program's
place against the float32 one) and the half-batch fault's; a state left
unchanged reads 1 by construction.  One JSON line per seed and reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve_readings(name: str, seed: int, seconds: float) -> dict:
    import torch
    from bench import correct
    from bench.drivers import serve_closed
    from bench.reference.common import Precision
    notes = {"keep": True}
    _, line = _run(name, seed, seconds, notes=notes)
    ctx = notes["ctx"]
    fin, picked, w = notes["finished"], notes["picked"], notes["weights"]
    prog, ctrl, wit, scale = [], [], [], []
    refs = serve_closed.reference_logits(ctx, w, fin, picked)
    lows = serve_closed.reference_logits(ctx, w, fin, picked,
                                         Precision("fp8"))
    bfs = serve_closed.reference_logits(ctx, w, fin, picked,
                                        Precision("bf16"))
    for i, ref, low, bf in zip(picked, refs, lows, bfs):
        prog.append(correct.gaps(ref, fin[i].served).cpu())
        ctrl.append(correct.gaps(ref, low.argmax(-1).tolist()).cpu())
        wit.append(correct.gaps(ref, bf.argmax(-1).tolist()).cpu())
        scale.append(float(ref.std(-1).mean()))
        del ref, low, bf
    torch.cuda.empty_cache()
    prog, ctrl, wit = torch.cat(prog), torch.cat(ctrl), torch.cat(wit)

    def stats(g):
        return {"widest": float(g.max()), "mean": float(g.mean()),
                "differ": float((g > 0).float().mean())}
    return {"program": stats(prog), "control": stats(ctrl),
            "bf16_witness": stats(wit),
            "logit_std": sum(scale) / len(scale), "tokens": len(prog),
            "correct": line["correct"], "metrics": line["metrics"]}


def train_readings(name: str, seed: int) -> dict:
    import torch
    from bench import correct, measure, model, spec, traffic
    from bench.reference import train as ref_train
    from bench.reference.common import Precision
    _, line = _run(name, seed, 1e-3)
    got = {"program": {k: c["value"] for k, c in line["checks"].items()}}
    _, faulty = _run(name, seed, 1e-3, fault="half_batch")
    got["half_batch"] = {k: c["value"] for k, c in faulty["checks"].items()}
    cell, cfg = spec.workload(name), spec.config(
        spec.cell_entry(spec.load_benchmark(), name)["config"])
    dev = torch.device("cuda")
    w = {k: t.cpu() for k, t in model.draw_weights(cfg, seed, dev).items()}
    rows = [torch.as_tensor(traffic.packed_rows(
        seed, j, cell["batch"], cell["seq_len"], cfg["vocab_size"],
        cell["documents"]), device=dev) for j in range(cell["check"]["steps"])]
    with measure.no_tf32():
        ref = ref_train.follow(w, cfg, rows, cell["opt"], dev)
        low = ref_train.follow(w, cfg, rows, cell["opt"], dev,
                               Precision("fp8"))
    nums = correct.train_numbers(low, ref, cell["check"]["min_grad_share"])
    got["control"] = {k: nums[k] for k in ("loss", "grad", "direction",
                                            "change")}
    got["stale_state"] = {"change": 1.0}
    return got


def _run(name, seed, seconds, fault="", notes=None):
    import torch
    from bench import run
    out, line = run.run_cell(name, seed, seconds, False, "cuda",
                             t0=time.perf_counter(), fault=fault, notes=notes)
    torch.cuda.empty_cache()
    return out, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    driver = spec.workload(args.workload)["driver"]
    for seed in args.seeds:
        got = (serve_readings(args.workload, seed, args.seconds)
               if driver == "serve_closed"
               else train_readings(args.workload, seed))
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

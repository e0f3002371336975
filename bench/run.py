#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Loads, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared beside its limit,
which also close standard error.  Exits non-zero with no result line
without a CUDA card, without the port beside it, or if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The port (``src``) and the benchmark's package on the path."""
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list[str]:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def result_line(ctx, out: dict, bench: dict, cell: str) -> dict:
    """The last line: the cell's metrics of this mode, from the traffic
    driver's numbers (``--trace 0``) or from each per-layer reader
    (``--trace 1``)."""
    import torch
    from bench import spec
    e2e, layers = spec.cell_metrics(bench, cell)
    metrics = {}
    if ctx.trace:
        for m in layers:
            value = spec.metric(m["name"]).read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    checks = {c["name"]: {"value": c["value"], "limit": c["limit"]}
              for c in out["checks"]}
    correct = (all(c["ok"] for c in out["checks"]) and out["failed"] == 0
               and out["attempted"] > 0)
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu",
              "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        prof = out["trace"]["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {k: [list(x) for x in prof[k]]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = checks
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float | None = None, fault: str = "", cell_over=None,
             cfg_over=None, notes: dict | None = None) -> tuple[dict, dict]:
    """One run of cell ``name``: ``(driver output, result line)``.  Tests
    pass a CPU device, smaller sizes (``cell_over``, ``cfg_over``: keys
    that replace the files') and a ``fault``; ``notes``, when given, is
    the run's context's own dict (``notes["ctx"]`` the context), where a
    driver asked to ``keep`` leaves what the control's readings reuse."""
    _paths()
    import torch
    from bench import spec
    from bench.context import Context
    bench = spec.load_benchmark()
    entry = spec.cell_entry(bench, name)
    cell = {**spec.workload(name), **(cell_over or {})}
    cfg = {**spec.config(entry["config"]), **(cfg_over or {})}
    ctx = Context(name=name, cell=cell, cfg=cfg, seed=seed, seconds=seconds,
                  trace=trace, device=torch.device(device),
                  t0=T0 if t0 is None else t0, fault=fault)
    if notes is not None:
        ctx.notes = notes
        notes["ctx"] = ctx
    out = spec.driver(cell["driver"]).run(ctx)
    return out, result_line(ctx, out, bench, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _paths()
    # the port builds its kernels into build/ here; nothing else compiles,
    # and any cache a library would keep stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    import torch
    from bench import spec
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: no src/repro_torch beside the benchmark",
              file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    chips = spec.cell_entry(bench, args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s), found "
              f"{found}", file=sys.stderr)
        return 2
    out, line = run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda")
    bad = loaded_forbidden()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    extra = {k: out[k] for k in ("counts", "readings", "sample", "window_s")
             if k in out}
    print(json.dumps({"detail": extra}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

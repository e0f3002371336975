"""Measurements of the executor's serving path on the card:
``python3 tools/torch_serve_bench.py`` from the repository root (one CUDA
card, ``nvcc``; about eight minutes).  A warm-up run of a small murmur3
takes the process's one-time set-up on the card before anything is
timed.

Part 1 — each Table III app at ``traffic.BENCH_SIZES`` and hash_table
at 16x, one request: the numpy oracle's wall, the windowed wall on
``TorchBackend()``, the resident wall (``execution="resident"``, the
capture excluded), whether both equal the oracle (DRAM; windowed also
``vm.stats``), the executor kernels' launches of each run, the resident
run's ticks and its capture seconds.

Part 2 — open-loop Poisson traffic as ``benchmarks/traffic_bench.py``
defines it, for every app whose windowed and resident walls in part 1 are
both under MAX_WALL_S (the others are listed with their walls, not run:
their batch-8 launches take seconds each and the run would outgrow its
ten minutes): at 0.5, 1 and 2 times the app's measured capacity (8 over the warm wall of
one closed-loop ``DataflowEngine.step_batch(8)``), with the SLO at 4 times
that wall, the same schedule through the closed-loop baseline (due
arrivals, then ``step_batch(8)``), ``AsyncServeEngine`` windowed
(max_wave 8) and ``AsyncServeEngine`` resident (buckets "auto", captured
by ``warmup()``).  Requests cycle over 8 instances from seeds 0-7 and two
tenants; each rate serves ``min(32, max(16, rate x HORIZON_S))``
requests (the reference's ``REVET_TRAFFIC_MAX_HORIZON_S`` cut).  Per cell: p50/p99 latency from the scheduled arrival, goodput at
the SLO (SLO-met share of the offered requests times the offered rate),
served + shed == submitted with no failure, every served response equal
to its instance's solo run on the oracle, and for the async engine no
degradation, no fallback to windowed and no capture while serving.

One JSON object a line on stdout, each beside the card's name and power
limit; the last is the whole record, also written to ``--out``
(default ``build/torch_serve_bench.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.serve import traffic as tr  # noqa: E402

SEED = 0
MAX_WALL_S = 1.0           # part 2: apps whose single walls are under it
RATES = (0.5, 1.0, 2.0)    # times the batch-8 capacity
REQUESTS = 32              # at most, a rate
HORIZON_S = 4.0            # at least 16 requests, else rate x HORIZON_S


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def single_runs(name, app, tb) -> dict:
    """Part 1 for one app instance."""
    from repro_torch.core.backend import NumpyBackend
    lowered = app.fn.lower(**app.dram_init, **app.params, **app.statics)
    want = lowered.compile(NumpyBackend()).execute(dict(app.dram_init),
                                                   app.params)
    compiled = lowered.compile(tb)
    rec = {"app": name, "oracle_wall_s": want.report.wall_s}
    for execution in ("windowed", "resident"):
        before = tr.executor_launches()
        got = compiled.execute(dict(app.dram_init), app.params,
                               execution=execution)
        after = tr.executor_launches()
        if execution == "windowed":
            tr.same_run(name, want, got)
        else:
            tr.same_resident(name, got, want)
            rec.update(ticks=got.vm.stats["ticks"],
                       capture_s=got.vm.capture_s, replays=got.vm.replays)
        rec[f"{execution}_wall_s"] = got.report.wall_s
        rec[f"{execution}_launches"] = {k: after[k] - before[k]
                                        for k in after}
    rec["match"] = True
    return rec


def open_loop(name, tb) -> dict:
    """Part 2 for one app: the three disciplines at each rate."""
    apps, lowered, solos = tr.serve_instances(name, tr.BENCH_SIZES[name])
    compiled = lowered.compile(tb)
    t_launch = tr.batch8_wall(compiled, apps)
    capacity = tr.SERVE_BATCH / t_launch
    slo_s = tr.SERVE_SLO_MULT * t_launch
    cells = []
    for k, mult in enumerate(RATES):
        offered = mult * capacity
        n = min(REQUESTS, max(2 * tr.SERVE_BATCH, int(offered * HORIZON_S)))
        sched = tr.poisson(n, offered, SEED + k)
        cell = {"mult": mult, "requests": n,
                "baseline": tr.rate_cell(
                    tr.drive_closed(compiled, apps, solos, sched), slo_s,
                    offered, n)}
        for execution in ("windowed", "resident"):
            d = tr.drive_async(compiled, apps, solos, sched, slo_s,
                               execution)
            tr.require_clean(name, d, execution)
            cell[f"async_{execution}"] = {
                **tr.rate_cell(d, slo_s, offered, n),
                **tr.async_summary(d), "warmup_s": d["warmup_s"]}
        cells.append(cell)
    return {"app": name, "t_launch8_s": t_launch, "capacity_rps": capacity,
            "slo_s": slo_s, "rates": cells}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "torch_serve_bench.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.backend import TorchBackend
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    tb = TorchBackend()
    record = {"card": smi, "single": [], "open_loop": [], "not_run": {}}
    # the process's first run on the card pays its one-time set-up (CUDA
    # context, allocator, library handles): take it before anything timed
    single_runs("warm-up", ALL_APPS["murmur3"](), tb)
    instances = {name: ALL_APPS[name](**size)
                 for name, size in sorted(tr.BENCH_SIZES.items())}
    instances["hash_table_16x"] = ALL_APPS["hash_table"](**tr.HASH_TABLE_16X)
    for name, app in instances.items():
        rec = single_runs(name, app, tb)
        record["single"].append(rec)
        emit({"part": "single", "card": smi, **rec})
    for rec in record["single"]:
        name = rec["app"]
        walls = {k: rec[f"{k}_wall_s"] for k in ("windowed", "resident")}
        if name not in tr.BENCH_SIZES or max(walls.values()) > MAX_WALL_S:
            record["not_run"][name] = walls
            continue
        out = open_loop(name, tb)
        record["open_loop"].append(out)
        emit({"part": "open_loop", "card": smi, **out})
    emit({"not_run": record["not_run"], "max_wall_s": MAX_WALL_S})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    emit(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Find every piece of the benchmark by its name.

``BENCHMARK.json`` (at the checkout's root) names the cells and metrics;
each piece lives in a file of its own, so that a later change adds files
and edits none:

* ``bench/configs/<config>.json``   one model configuration;
* ``bench/workloads/<cell>.json``   one cell: its config, driver, traffic
  parameters and the limits that decide ``correct``;
* ``bench/drivers/<driver>.py``     one traffic driver (``run(ctx)``);
* ``bench/metrics/<metric>.py``     one per-layer metric's reader
  (``read(trace)``), shared by the splits ``<metric>.<split>``;
* ``bench/reference/<family>.py``   the plain float32 reference of a family.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return _json(BENCH / "workloads" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def reference(family: str):
    return importlib.import_module(f"bench.reference.{family}")


def metric_file(name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    for a split quantity ``<quantity>.<split>`` (one quantity that moves a
    different end-to-end metric in different cells) the quantity's
    ``metrics/<quantity>.py`` where the split has no file of its own."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return path


def metric(name: str):
    """The reader module of per-layer metric ``name``: metric names may
    hold dots, so it is loaded from its file, not imported by name.  Its
    ``read(trace)`` returns the value, or None where the trace holds
    nothing to read; ``BENCHMARK.json``'s entry alone gives the metric's
    unit, source, layer, ``moves`` and cells."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{path.stem.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in ``cell``."""
    return "workloads" not in entry or cell in entry["workloads"]


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    return ([m for m in bench["end_to_end"] if applies(m, cell)],
            [m for m in bench["per_layer"] if applies(m, cell)])


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in bench['workloads']]})")

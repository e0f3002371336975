"""Every file of the benchmark loads, names only known pieces, and keeps to
the limits that BENCHMARK.json's readers hold it to."""
from __future__ import annotations

import json
import re

import pytest

from bench import model, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1] == "bench/run.py"
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert _line(e["why"])


def test_bounds():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = spec.config(entry["name"])
    assert entry["file"] == f"bench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["family"] in ("dense", "moe")
    spec.reference(cfg["family"])
    shapes = model.layout(cfg)
    assert shapes["embed.tok"][0][0] == model.vocab_padded(cfg)
    assert any(c["config"] == entry["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_workload_file(name):
    entry = spec.cell_entry(BENCH, name)
    cell = spec.workload(name)
    assert entry["chips"] == 1
    assert cell["config"] == entry["config"]
    assert name == f"{entry['config']}.{entry['traffic']}"
    assert cell["traffic"] == entry["traffic"] and cell["why"] == entry["why"]
    assert hasattr(spec.driver(cell["driver"]), "run")
    assert spec.config(entry["config"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_setup_another_and_a_layer(name):
    e2e, layers = spec.cell_metrics(BENCH, name)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layers
    for m in layers:
        assert m["moves"] in names, (m["name"], m["moves"])


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_file_agrees(name):
    """Each listed metric has a reader, which finds nothing in an empty
    trace; BENCHMARK.json's entry is the only record of its unit, source,
    layer, moves and cells, so a new cell edits no reader."""
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert spec.metric_file(name).is_file()
    mod = spec.metric(name)
    assert set(vars(mod)) & {"UNIT", "SOURCE", "LAYER", "MOVES",
                             "CELLS"} == set()
    assert set(entry["workloads"]) <= set(CELLS)
    assert mod.read({}) is None


SPLITS = [m for m in PER_LAYER if "." in m]


@pytest.mark.parametrize("name", SPLITS)
def test_split_reads_with_its_quantity(name):
    """A split ``<metric>.<split>`` with no file of its own is read by
    ``metrics/<metric>.py``, and reads what that reader reads."""
    quantity = name.split(".")[0]
    assert not (spec.BENCH / "metrics" / f"{name}.py").exists()
    assert spec.metric_file(name) == spec.metric_file(quantity)
    trace = {"cfg": spec.config("qwen2-0.5b"),
             "ttft_ms": [10.0, 30.0], "itl_ms": [1.0, 3.0],
             "decode_ms": [4.0], "prefill": [(200.0, 1024)],
             "profile": {"busy_s": 1.0, "window_s": 2.0}}
    assert spec.metric(name).read(trace) == \
        spec.metric(quantity).read(trace)


def test_every_reader_is_listed():
    used = {spec.metric_file(m).name for m in PER_LAYER}
    assert {p.name for p in (spec.BENCH / "metrics").glob("*.py")} == used


def test_one_layer_name_per_layer():
    seen = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        seen.setdefault(m["layer"], set()).add(m["name"])
    assert "device" in seen


def test_check_budget_of_a_full_check():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200

"""A whole run, the look for a card skipped, at a tiny size on the CPU: the
sound run comes out correct, and each fault the cell can have, planted
underneath the harness, comes out not correct.  The port runs float32
here, so the sound run agrees with the reference to rounding."""
from __future__ import annotations

import time

import pytest

from bench import run

TINY_DENSE = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=8, intermediate_size=48,
                  vocab_size=300, torch_dtype="float32")
TINY_MOE = dict(TINY_DENSE, num_key_value_heads=4, num_experts=8,
                num_experts_per_tok=2, intermediate_size=16)
SERVE = dict(slots=3, max_len=64, warm_steps=2, profile_seconds=0.1,
             prompt={"kind": "uniform", "lo": 8, "hi": 40},
             output={"kind": "uniform", "lo": 4, "hi": 10})
TRAIN = dict(batch=2, seq_len=32, profile_steps=1,
             documents={"kind": "lognormal", "median": 8, "sigma": 1.0,
                        "lo": 2, "hi": 32})

CASES = {
    "olmoe-1b-7b.rag_prefill": (TINY_MOE, SERVE, ("token", "stale_state")),
    "qwen2-0.5b.longdoc_prefill": (TINY_DENSE, SERVE,
                                   ("token", "stale_state")),
    "qwen2-0.5b.train_4k": (TINY_DENSE, TRAIN, ("stale_state",
                                                "half_batch")),
}
RUNS = [(cell, f) for cell, (_, _, faults) in CASES.items()
        for f in ("",) + faults]


def _run(cell, fault, trace=False):
    cfg_over, cell_over, _ = CASES[cell]
    from bench import spec
    check = dict(spec.workload(cell)["check"])
    if "tokens" in check:
        check["tokens"] = 24
    return run.run_cell(cell, 2**33 + 17, 0.3, trace, "cpu",
                        t0=time.perf_counter(), fault=fault,
                        cfg_over=cfg_over,
                        cell_over={**cell_over, "check": check})


@pytest.mark.parametrize("cell,fault", RUNS,
                         ids=[f"{c}-{f or 'sound'}" for c, f in RUNS])
def test_fault_makes_the_run_incorrect(cell, fault):
    out, line = _run(cell, fault)
    assert line["correct"] is (not fault), line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_traced_run_reads_its_layers(cell):
    out, line = _run(cell, "", trace=True)
    assert line["correct"]
    assert line["metrics"], line
    assert "breakdown" in line and "busy_s" in line["device"]

"""The KV cache write of a decode step, two ways, on the card:
``python3 tools/probe_cache_write.py`` from the repository root (one CUDA
card; under a minute).

``layers._cache_write`` replaces one row of each sequence's cache.  It is
written as a masked select (``torch.where`` of a [B, 1, S, 1] row mask),
which runs on plain tensors and on DTensors alike; the plain-tensor path
used to clone the cache and write the rows by an index.  Both read the
whole cache once and write it once.  This times, with CUDA events (eager,
host issue included), alternating the two forms (A B B A, each time the
median of ``REPS`` calls):

* one cache write of a layer, at the served shapes of ``chip_smoke.py``'s
  ``lm`` phase (qwen2-0.5b: 4 slots, 2 KV heads of 64, 1024 rows) and at
  a 32768-row cache;
* ``zoo.decode_step`` of qwen2-0.5b at its published widths (random
  weights from seed 0, bf16) over those caches, every layer writing K and
  V.

Each form's caches and logits must be equal bit for bit.  Prints the
card's name and power limit, one JSON object a line, and the whole record
last.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402

REPS = 50
SHAPES = ((4, 1024), (4, 32768))      # (slots, cache rows)


def clone_write(cache, kv, position):
    """The plain-tensor form the port had: a clone, rows written by an
    index."""
    pos = position.long().clamp(0, cache.shape[2] - 1)
    out = cache.clone()
    rows = torch.arange(cache.shape[0], device=cache.device)
    out[rows, :, pos] = kv[:, :, 0]
    return out


FORMS = {"select": L._cache_write, "clone_index": clone_write}


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def ab(fns: dict) -> dict:
    """Each form's ms, A B B A, the two times of each kept."""
    out = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for k in order:
        out[k].append(event_ms(fns[k]))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    dev = torch.device("cuda")
    cfg = get_config("qwen2-0.5b")
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    record = {"card": card.strip(), "torch": torch.__version__, "rows": []}
    for b, s in SHAPES:
        cache = {k: torch.randn((cfg.n_layers, b, cfg.n_kv_heads, s, cfg.hd),
                                generator=gen, device=dev,
                                dtype=torch.bfloat16) for k in ("k", "v")}
        kv = torch.randn((b, cfg.n_kv_heads, 1, cfg.hd), generator=gen,
                         device=dev, dtype=torch.bfloat16)
        position = torch.randint(0, s, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)
        token = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                              device=dev, dtype=torch.int32)
        layer = cache["k"][0]
        writes = {k: f(layer, kv, position) for k, f in FORMS.items()}
        same_write = torch.equal(writes["select"], writes["clone_index"])
        steps = {}
        for k, f in FORMS.items():
            L._cache_write = f
            steps[k] = zoo.decode_step(params, token, cache, position)
        L._cache_write = FORMS["select"]
        same_step = torch.equal(steps["select"][0], steps["clone_index"][0]) \
            and all(torch.equal(steps["select"][1][n],
                                steps["clone_index"][1][n])
                    for n in ("k", "v"))
        del writes, steps
        write_ms = ab({k: (lambda f=f: f(layer, kv, position))
                       for k, f in FORMS.items()})

        def step(f):
            L._cache_write = f
            zoo.decode_step(params, token, cache, position)

        step_ms = ab({k: (lambda f=f: step(f)) for k, f in FORMS.items()})
        L._cache_write = FORMS["select"]
        row = {"slots": b, "rows": s, "bytes_read_and_written":
               2 * layer.numel() * layer.element_size(),
               "write_ms": write_ms, "decode_step_ms": step_ms,
               "equal_write": same_write, "equal_step": same_step}
        print(json.dumps(row), flush=True)
        record["rows"].append(row)
        if not (same_write and same_step):
            raise SystemExit("the two forms differ")
        del cache
        torch.cuda.empty_cache()
    print(json.dumps(record))


if __name__ == "__main__":
    main()

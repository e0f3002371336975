"""The decode attention's two routes through one decode step, on the card:
``python3 tools/probe_decode_route.py`` from the repository root (one CUDA
card; a few minutes).

``layers.decode_attention_step`` sends the attention over a plain CUDA
cache to the hand-written ``decode_attention`` kernel, which reads each
slot's K and V in bf16 once, up to its length; every other cache keeps
the grouped float32 reference (``decode_mha(impl="ref")``), which casts
the whole cache of every layer to float32 and scores every row.  This
times ``zoo.decode_step`` with CUDA events (eager, host issue included),
kernel route against the reference route (forced by replacing
``layers._decode_route``), alternating A B B A, each time the median of
``REPS`` calls, at the shapes of two serving cells:

* qwen2-0.5b, 16 slots of 32768 rows (long-document QA: prompts
  8192-24576, answers 32-128);
* olmoe-1b-7b, 64 slots of 2048 rows (chat: prompts 128-1024, answers
  128-512).

Both at their published widths and depths, random bf16 weights from seed
0 and a random bf16 cache.  Each slot's position is drawn as the closed
loop leaves it mid-request: a prompt length, plus a uniform share of an
answer length, both from the cell's ranges.  Prints, per shape, the two
routes' step times, the largest logit gap between them (and over the
largest logit), the share of slots whose greedy token agrees, and the
recorder's ``decode.*`` counters of one kernel-route step; the card's
name and power limit first, the whole record last.  The first layer's
attention output is compared alone too: random weights leave near ties
everywhere (olmoe's router above all), so a rounding difference in one
layer can change later layers' experts and the logits by far more.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402

REPS = 20
# (arch, slots, rows, prompt range, answer range)
SHAPES = (("qwen2-0.5b", 16, 32768, (8192, 24576), (32, 128)),
          ("olmoe-1b-7b", 64, 2048, (128, 1024), (128, 512)))


def force_ref(cache):
    return "ref"


ROUTES = {"kernel": L._decode_route, "ref": force_ref}


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


def positions(rng, slots, prompt, answer, rows) -> np.ndarray:
    """Mid-request positions of a closed loop: prompt + a uniform share of
    the answer, below the cache's last row."""
    p = rng.integers(prompt[0], prompt[1] + 1, slots)
    out = rng.integers(answer[0], answer[1] + 1, slots)
    return np.minimum(p + (rng.random(slots) * out).astype(np.int64),
                      rows - 2)


def probe(arch, slots, rows, prompt, answer, dev) -> dict:
    cfg = get_config(arch)
    zoo = get_model(cfg)
    params = zoo.init_params(0)
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(1)
    cache = {k: torch.randn(t.shape, generator=gen, device=dev,
                            dtype=t.dtype)
             for k, t in zoo.abstract_cache(slots, rows).items()}
    position = torch.from_numpy(positions(rng, slots, prompt, answer,
                                          rows).astype(np.int32)).to(dev)
    token = torch.from_numpy(rng.integers(1, cfg.vocab, (slots, 1)).astype(
        np.int32)).to(dev)

    def step(route):
        L._decode_route = ROUTES[route]
        try:
            return zoo.decode_step(params, token, cache, position)[0]
        finally:
            L._decode_route = ROUTES["kernel"]

    logits = {r: step(r)[:, 0, :cfg.vocab].float() for r in ROUTES}
    gap = float((logits["kernel"] - logits["ref"]).abs().max())
    top = float(logits["ref"].abs().max())
    agree = float((logits["kernel"].argmax(-1) == logits["ref"].argmax(-1))
                  .float().mean())
    del logits
    # the first layer's attention alone, on the same input: the routes'
    # own difference, before later layers (and a MoE's router) carry it
    lp = layer_params(params, 0)
    x = L.apply_norm(lp["ln1"], L.embed(params["embed"], token), cfg)
    attn = {}
    for r in ROUTES:
        L._decode_route = ROUTES[r]
        attn[r] = L.decode_attention_step(
            lp["attn"], x, cfg, cache["k"][0], cache["v"][0],
            position)[0].float()
    L._decode_route = ROUTES["kernel"]
    attn_gap = float((attn["kernel"] - attn["ref"]).abs().max())
    attn_top = float(attn["ref"].abs().max())
    del attn
    ms = {r: [] for r in ROUTES}
    for r in ("kernel", "ref", "ref", "kernel"):
        ms[r].append(event_ms(lambda r=r: step(r)))
    tracing.enable()
    step("kernel")
    counters = {k[0]: v for k, v in tracing.drain()["counters"].items()
                if k[0].startswith("decode.")}
    tracing.disable()
    live = counters["decode.keys_read"] / counters["decode.keys_held"]
    row = {"arch": arch, "slots": slots, "rows": rows,
           "position_min": int(position.min()),
           "position_max": int(position.max()),
           "decode_step_ms": ms,
           "speedup": sorted(ms["ref"])[0] / sorted(ms["kernel"])[-1],
           "layer0_attn_gap_max": attn_gap,
           "layer0_attn_gap_over_max": attn_gap / attn_top,
           "logit_gap_max": gap, "logit_gap_over_max_logit": gap / top,
           "greedy_agree_share": agree, "counters": counters,
           "keys_read_share": live}
    del cache, params
    torch.cuda.empty_cache()
    return row


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    dev = torch.device("cuda")
    record = {"card": card.strip(), "torch": torch.__version__, "rows": []}
    for shape in SHAPES:
        row = probe(*shape, dev)
        print(json.dumps(row), flush=True)
        record["rows"].append(row)
    print(json.dumps(record))


if __name__ == "__main__":
    main()

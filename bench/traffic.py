"""The one generator of traffic: sizes and token ids from a workload's
parameters and the run's seed.

Every seed gets the same sizes in the same order: request ``i``'s
quantile is the van der Corput point ``i + 1`` (base 2 for the prompt,
base 3 for the output, base 5 for a first request's residual budget), so
any run of consecutive requests covers the distribution evenly, and the
closed loop admits the same sizes at the same steps whatever the seed (a
seed that changed the sizes changed the work: on an H100 two runs of one
seed agreed within 1% at longdoc_prefill's p90, while seeds parted by
10%).  The seed draws the token ids, uniform over ``[1, vocab)`` (0 is
the engine's EOS), from ``(seed, i)``, and the weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


def van_der_corput(i: int, base: int) -> float:
    out, denom = 0.0, 1.0
    while i:
        i, digit = divmod(i, base)
        denom *= base
        out += digit / denom
    return out


def size(dist: dict, u: float) -> int:
    """The size at quantile ``u`` of ``dist``: ``{"kind": "uniform", "lo",
    "hi"}`` (integers, both ends in) or ``{"kind": "lognormal", "median",
    "sigma", "lo", "hi"}`` (clipped to ``[lo, hi]``)."""
    lo, hi = dist["lo"], dist["hi"]
    if dist["kind"] == "uniform":
        return min(hi, lo + int(u * (hi - lo + 1)))
    if dist["kind"] == "lognormal":
        z = NormalDist().inv_cdf(min(max(u, 1e-12), 1 - 1e-12))
        return int(min(hi, max(lo, round(dist["median"]
                                         * math.exp(dist["sigma"] * z)))))
    raise ValueError(f"unknown size distribution {dist['kind']!r}")


@dataclass
class Stream:
    """Requests ``(prompt ids, max_new)`` of one run, numbered from 0."""
    prompt: dict
    output: dict
    vocab: int
    seed: int

    def quantiles(self, i: int) -> tuple[float, float]:
        return van_der_corput(i + 1, 2), van_der_corput(i + 1, 3)

    def sizes(self, i: int) -> tuple[int, int]:
        up, uo = self.quantiles(i)
        return size(self.prompt, up), size(self.output, uo)

    def ids(self, i: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1, i])
        return rng.integers(1, self.vocab, n, dtype=np.int64).astype(np.int32)

    def warm_ids(self, n: int) -> np.ndarray:
        """Ids of the warm-up prompt, apart from every request's."""
        rng = np.random.default_rng([self.seed, 4])
        return rng.integers(1, self.vocab, n, dtype=np.int64).astype(np.int32)

    def residual(self, i: int, max_new: int) -> int:
        """An output budget uniform over ``[1, max_new]``: what is left of
        request ``i`` when the window finds it half done."""
        return 1 + int(van_der_corput(i + 1, 5) * max_new)

    def request(self, i: int) -> tuple[np.ndarray, int]:
        s, m = self.sizes(i)
        return self.ids(i, s), m


def packed_rows(seed: int, step: int, batch: int, seq_len: int, vocab: int,
                doc: dict) -> np.ndarray:
    """``[batch, seq_len]`` int32 of packed documents for training step
    ``step``: lengths from ``doc`` (drawn from ``(seed, step)``), uniform
    ids over ``[1, vocab)``, each document followed by EOS (0); the last
    one is cut at the row's end.  Every step's rows differ."""
    rng = np.random.default_rng([seed, 2, step])
    rows = rng.integers(1, vocab, (batch, seq_len), dtype=np.int64)
    for r in range(batch):
        at = 0
        while True:
            at += size(doc, rng.random())
            if at >= seq_len:
                break
            rows[r, at] = 0
            at += 1
    return rows.astype(np.int32)

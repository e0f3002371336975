"""Deterministic synthetic data pipeline, sharded by host.

Every (step, host) pair maps to a disjoint, reproducible token block through
numpy's generator seeded with the counter ``(seed, step, host)``: no state
to checkpoint beyond the step, so a restart replays the same batches, which
the fault-tolerance path relies on.  Sequences are packed documents: random
tokens with EOS planted at random cuts.  The numbers are the reference's
(``repro.data.pipeline``) bit for bit; ``batch`` puts them on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.params import resolve_device

EOS = 0


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    mean_doc_len: int = 512
    seed: int = 1234


class Pipeline:
    """Stateless-per-step pipeline: ``batch(step)`` is pure."""

    def __init__(self, cfg: DataConfig, host_id: int = 0):
        self.cfg = cfg
        self.host_id = host_id
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed, step, self.host_id))

    def local_batch_np(self, step: int) -> np.ndarray:
        """This host's [local_batch, seq_len] int32 tokens of ``step``."""
        rng = self._rng(step)
        b, s, v = self.local_batch, self.cfg.seq_len, self.cfg.vocab
        toks = rng.integers(1, v, size=(b, s), dtype=np.int32)
        # plant EOS boundaries (packed documents)
        n_docs = max(1, s // self.cfg.mean_doc_len)
        for row in range(b):
            cuts = rng.integers(1, s, size=n_docs)
            toks[row, cuts] = EOS
        return toks

    def batch(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """``{"tokens": int32 [local_batch, seq_len]}`` on ``device``
        (``None``: the card)."""
        dev = resolve_device(device, "Pipeline.batch")
        return {"tokens": torch.from_numpy(self.local_batch_np(step)).to(dev)}

    def global_batch_np(self, step: int) -> np.ndarray:
        """All hosts' shards concatenated (single-process testing)."""
        return np.concatenate([Pipeline(self.cfg, host_id=h)
                               .local_batch_np(step)
                               for h in range(self.cfg.n_hosts)], axis=0)

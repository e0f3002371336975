"""Model zoo: one uniform interface over the architectures the port serves.

    zoo = get_model(cfg)
    zoo.spec()                      # parameter spec tree (P leaves)
    zoo.init_params(seed, device)   # the reference's weights, as tensors
    zoo.batch_specs(shape)          # {name: (shape, dtype)} of a batch
    zoo.make_batch(shape, seed)     # the reference's batch, as tensors
    zoo.loss_fn(params, batch)      # training loss (impl "chunked")
    zoo.prefill / zoo.decode_step / zoo.init_cache

All six families are ported, training and serving.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import encdec, moe, rglru, ssm, transformer, vlm
from .params import init, n_params, resolve_device

_ENC_LEN_CAP = 4096   # encoder length for enc-dec cells (DESIGN.md)


@dataclasses.dataclass
class Zoo:
    cfg: ModelConfig
    mod: object

    # -- parameters ---------------------------------------------------------
    def spec(self):
        return self.mod.model_spec(self.cfg)

    def init_params(self, seed: int = 0, device=None):
        """The reference's ``init_params(seed)``, bit for bit, on ``device``
        (``None``: the card)."""
        return init(self.spec(), seed, device)

    def n_params(self) -> int:
        return n_params(self.spec())

    # -- training -----------------------------------------------------------
    def loss_fn(self, params, batch, impl: str = "chunked"):
        """The family's ``loss_fn`` (fused cross-entropy, remat) on a batch
        of ``batch_specs``' keys."""
        return self.mod.loss_fn(params, batch, self.cfg, impl=impl)

    # -- inputs -------------------------------------------------------------
    def batch_specs(self, shape: ShapeConfig) -> dict:
        """``{name: (shape, dtype)}`` of a batch at this cell: ``tokens``,
        then the stubbed frontend's ``frames`` (encdec) or
        ``patch_embeds`` (vlm)."""
        b, s = shape.global_batch, shape.seq_len
        specs = {"tokens": ((b, s), torch.int32)}
        if self.cfg.family == "encdec":
            specs["frames"] = ((b, min(s, _ENC_LEN_CAP), encdec.FRAME_DIM),
                               torch.float32)
        if self.cfg.family == "vlm":
            specs["patch_embeds"] = ((b, self.cfg.n_patches,
                                      self.cfg.vit_width), torch.bfloat16)
        return specs

    def make_batch(self, shape: ShapeConfig, seed: int = 0, device=None):
        """The reference's ``make_batch``: the same numbers, drawn from
        ``default_rng(seed)`` in ``batch_specs`` order, on ``device``
        (``None``: the card)."""
        dev = resolve_device(device, "make_batch")
        rng = np.random.default_rng(seed)
        out = {}
        for k, (shp, dt) in self.batch_specs(shape).items():
            if dt == torch.int32:
                a = rng.integers(0, self.cfg.vocab, shp).astype(np.int32)
                out[k] = torch.from_numpy(a).to(dev)
            else:   # float64 draws, rounded once to the leaf's dtype
                a = torch.from_numpy(rng.standard_normal(shp))
                out[k] = a.to(dt).to(dev)
        return out

    # -- serving -----------------------------------------------------------------
    def _cache_len(self, max_len: int) -> int:
        # VLM caches cover [patches ; text]
        if self.cfg.family == "vlm":
            return max_len + self.cfg.n_patches
        return max_len

    def init_cache(self, batch: int, max_len: int, device=None):
        return self.mod.init_cache(self.cfg, batch, self._cache_len(max_len),
                                   device=device)

    def decode_step(self, params, token, cache, position):
        return self.mod.decode_step(params, token, cache, position, self.cfg)

    def prefill(self, params, batch, max_len: int, impl: str = "chunked"):
        if self.cfg.family == "encdec":
            return self.mod.prefill(params, batch["frames"],
                                    batch["tokens"], self.cfg, max_len,
                                    impl=impl)
        if self.cfg.family == "vlm":
            return self.mod.prefill(params, batch["patch_embeds"],
                                    batch["tokens"], self.cfg,
                                    self._cache_len(max_len), impl=impl)
        return self.mod.prefill(params, batch["tokens"], self.cfg, max_len,
                                impl=impl)


_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "encdec": encdec,
    "ssm": ssm,
    "hybrid": rglru,
    "vlm": vlm,
}


def get_model(cfg: ModelConfig) -> Zoo:
    return Zoo(cfg, _FAMILIES[cfg.family])

"""Model zoo: one uniform interface over the architectures the port serves.

    zoo = get_model(cfg)
    zoo.spec()                      # parameter spec tree (P leaves)
    zoo.init_params(seed, device)   # the reference's weights, as tensors
    zoo.prefill / zoo.decode_step / zoo.init_cache

The dense, MoE, SSM and hybrid families are ported so far; the others raise,
naming the ROADMAP item that brings them.  Training (``loss_fn``, batch specs) comes
with the training slice.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig
from . import moe, rglru, ssm, transformer
from .params import init, n_params


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

    # -- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        return self.mod.init_cache(self.cfg, batch, max_len, device=device)

    def decode_step(self, params, token, cache, position):
        return self.mod.decode_step(params, token, cache, position, self.cfg)

    def prefill(self, params, batch, max_len: int, impl: str = "chunked"):
        return self.mod.prefill(params, batch["tokens"], self.cfg, max_len,
                                impl=impl)


_FAMILIES = {"dense": transformer, "moe": moe, "ssm": ssm, "hybrid": rglru}

# where each family not yet ported stands in ROADMAP.md
_PENDING = {
    "encdec": "Queue 1 item 3 (models/encdec.py)",
    "vlm": "Queue 1 item 3 (models/vlm.py)",
}


def get_model(cfg: ModelConfig) -> Zoo:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP {_PENDING.get(cfg.family, 'Queue 1')})")
    return Zoo(cfg, _FAMILIES[cfg.family])

"""Uniform model API (counterpart of ``repro.models.registry``) for the
ported families: dense (``transformer``) and rglru (``rglru``).

    model = get_model(cfg)
    params = model.init(generator, device)
    logits = model.forward(params, {"tokens": tokens})
    last, cache = model.prefill(params, {"tokens": tokens}, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)
"""
from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, rglru, transformer

_FAMILIES = {"dense": transformer, "rglru": rglru}


@dataclass
class Model:
    cfg: ModelConfig
    impl: ModuleType            # the family's module

    def param_specs(self):
        return self.impl.param_specs(self.cfg)

    def init(self, generator: torch.Generator, device):
        return common.init_params(self.param_specs(), generator, device)

    def forward(self, params, batch, *, last_only=False):
        return self.impl.forward(self.cfg, params, batch, last_only=last_only)

    def prefill(self, params, batch, max_len):
        return self.impl.prefill(self.cfg, params, batch["tokens"], max_len)

    def decode_step(self, params, cache, tokens, pos):
        return self.impl.decode_step(self.cfg, params, cache, tokens, pos)

    def cache_spec(self, batch, max_len):
        return self.impl.cache_spec(self.cfg, batch, max_len)

    def init_cache(self, batch, max_len, device):
        return self.impl.init_cache(self.cfg, batch, max_len, device)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; see ROADMAP.md "
            "Queue 1 for the order in which the families follow")
    return Model(cfg, _FAMILIES[cfg.family])

"""Uniform model API (counterpart of ``repro.models.registry``), dense
family only.

    model = get_model(cfg)
    params = model.init(generator, device)
    logits = model.forward(params, {"tokens": tokens})
    last, cache = model.prefill(params, {"tokens": tokens}, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models import transformer


@dataclass
class Model:
    cfg: ModelConfig

    def param_specs(self):
        return transformer.param_specs(self.cfg)

    def init(self, generator: torch.Generator, device):
        return common.init_params(self.param_specs(), generator, device)

    def forward(self, params, batch, *, return_cache=False, last_only=False):
        return transformer.forward(self.cfg, params, batch,
                                   return_cache=return_cache,
                                   last_only=last_only)

    def prefill(self, params, batch, max_len):
        return transformer.prefill(self.cfg, params, batch["tokens"], max_len)

    def decode_step(self, params, cache, tokens, pos):
        return transformer.decode_step(self.cfg, params, cache, tokens, pos)

    def cache_spec(self, batch, max_len):
        return transformer.cache_spec(self.cfg, batch, max_len)

    def init_cache(self, batch, max_len, device):
        return transformer.init_cache(self.cfg, batch, max_len, device)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; see ROADMAP.md "
            "Queue 1 for the order in which the families follow")
    return Model(cfg)

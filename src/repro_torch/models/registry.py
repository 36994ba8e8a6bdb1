"""Uniform model API (counterpart of ``repro.models.registry``) for every
family: dense, moe and mla_moe (``transformer``), encdec (``encdec``),
rglru (``rglru``) and xlstm (``xlstm``).

    model = get_model(cfg)
    params = model.init(generator, device)
    shapes = model.abstract_params()     # meta tensors, nothing allocated
    logits = model.forward(params, {"tokens": tokens})
    last, cache = model.prefill(params, {"tokens": tokens}, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)
    batch = model.input_specs(cell)      # meta tensors for the dry-run

The encoder-decoder's batch also carries ``enc_embeds`` (B, encoder_seq,
D), and its ``prefill`` receives the whole batch, as JAX's does; the
other families' receive its tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import common, encdec, rglru, transformer, xlstm

_FAMILIES = {"dense": transformer, "moe": transformer,
             "mla_moe": transformer, "encdec": encdec, "rglru": rglru,
             "xlstm": xlstm}


@dataclass
class Model:
    cfg: ModelConfig
    impl: ModuleType            # the family's module

    def param_specs(self):
        return self.impl.param_specs(self.cfg)

    def abstract_params(self):
        return common.abstract_params(self.param_specs())

    def init(self, generator: torch.Generator, device):
        return common.init_params(self.param_specs(), generator, device)

    def forward(self, params, batch, *, remat=False, last_only=False):
        return self.impl.forward(self.cfg, params, batch, remat=remat,
                                 last_only=last_only)

    def prefill(self, params, batch, max_len):
        if self.cfg.family == "encdec":
            return self.impl.prefill(self.cfg, params, batch, max_len)
        return self.impl.prefill(self.cfg, params, batch["tokens"], max_len)

    def decode_step(self, params, cache, tokens, pos):
        return self.impl.decode_step(self.cfg, params, cache, tokens, pos)

    def cache_spec(self, batch, max_len):
        return self.impl.cache_spec(self.cfg, batch, max_len)

    def init_cache(self, batch, max_len, device):
        return self.impl.init_cache(self.cfg, batch, max_len, device)

    def input_specs(self, cell: ShapeCell):
        """Meta-device stand-ins for every model input of a shape cell, at
        JAX's shapes and dtypes: int32 ``tokens`` (and ``targets`` to
        train) of (B, S), Whisper's bf16 ``enc_embeds`` (B, encoder_seq,
        D); a decode cell's one new token (B, 1)."""
        B, S = cell.global_batch, cell.seq_len

        def tok(b, s):
            return torch.empty((b, s), dtype=torch.int32, device="meta")
        if cell.kind == "decode":
            return {"tokens": tok(B, 1)}
        batch = {"tokens": tok(B, S)}
        if cell.kind == "train":
            batch["targets"] = tok(B, S)
        if self.cfg.family == "encdec":
            batch["enc_embeds"] = torch.empty(
                (B, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=torch.bfloat16, device="meta")
        return batch


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}")
    return Model(cfg, _FAMILIES[cfg.family])

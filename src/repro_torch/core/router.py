"""CoE routers (counterpart of ``repro.core.router``).

  * ``LMRouter`` - the paper's design: an LM backbone of the experts' family
    with a classification head over experts, read from the last token's
    hidden state after the final norm.
  * ``HashRouter`` - a deterministic, weight-free router, bit-identical to
    the JAX package's.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params, spec


@dataclass
class LMRouter:
    cfg: ModelConfig
    n_experts: int

    def param_specs(self):
        return {"backbone": get_model(self.cfg).param_specs(),
                "head": spec((self.cfg.d_model, self.n_experts),
                             ("embed", "experts_r"))}

    def init(self, generator: torch.Generator, device):
        return init_params(self.param_specs(), generator, device)

    @torch.no_grad()
    def logits(self, params, tokens) -> torch.Tensor:
        """tokens (B,S) -> (B, n_experts) f32, on the params' device."""
        head = params["head"]
        tokens = torch.as_tensor(tokens, device=head.device).long()
        h = self._last_hidden(params["backbone"], tokens)
        return h.float() @ head.float()

    def _last_hidden(self, bparams, tokens):
        cfg = self.cfg
        B, S = tokens.shape
        h = T.embed_tokens(cfg, bparams, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for i in range(cfg.n_layers):
            h, _ = T._layer(cfg, T.layer_params(bparams, i), h, positions)
        return L.apply_norm(cfg, bparams["final_norm"], h[:, -1])

    def route(self, params, tokens) -> np.ndarray:
        """tokens (B,S) -> (B,) expert indices, on the host."""
        return self.logits(params, tokens).argmax(-1).cpu().numpy()


class HashRouter:
    """Deterministic router: stable hash of the prompt token ids."""

    def __init__(self, n_experts: int, seed: int = 0):
        self.n_experts = n_experts
        self.seed = seed

    def route_host(self, tokens: np.ndarray) -> np.ndarray:
        out = []
        for row in np.asarray(tokens):
            hsh = hashlib.sha256(
                row.tobytes() + str(self.seed).encode()).digest()
            out.append(int.from_bytes(hsh[:4], "big") % self.n_experts)
        return np.asarray(out, np.int32)

    def route(self, params, tokens) -> np.ndarray:
        return self.route_host(np.asarray(tokens))

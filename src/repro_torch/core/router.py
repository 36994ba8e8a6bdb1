"""CoE routers (counterpart of ``repro.core.router``). ``HashRouter`` is
bit-identical to the JAX package's; ``LMRouter`` is not ported yet."""
from __future__ import annotations

import hashlib

import numpy as np


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

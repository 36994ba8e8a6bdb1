"""Composition of Experts (counterpart of ``repro.core.coe``): one router +
N experts of one backbone, the experts on the capacity tier until activated
into the HBM weight cache.

One inference through ``generate``: route the prompt batch, group the
prompts per expert (paper §VI-C BS > 1 semantics), activate each group's
expert (prefetching the next group's), then prefill and greedy decode on
the dense cache with the model's plain ``decode_step``. Continuous-batching
serving goes through ``serving.engine.ServingEngine``."""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import tree_bytes
from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory_tiers import HBMBudget
from repro_torch.core.switching import HBMWeightCache
from repro_torch.models import get_model
from repro_torch.store import ExpertStore, HostMemoryStore


@dataclass
class ExpertHandle:
    """One expert of the composition. ``host_params`` is a tree of tensors
    (on any device); registration copies it into the store and drops it."""
    name: str
    cfg: ModelConfig
    host_params: Any = None
    domain: str = "general"

    @functools.cached_property
    def nbytes(self) -> int:
        if self.host_params is None:
            raise ValueError(
                f"expert {self.name}: nbytes unknown before registration")
        return tree_bytes(self.host_params)


@dataclass
class GenerationResult:
    tokens: np.ndarray
    switch_seconds: float
    exec_seconds: float
    route_seconds: float
    expert_of_prompt: np.ndarray


class CompositionOfExperts:
    """The Samba-CoE execution substrate on the three-tier memory system."""

    def __init__(self, router, router_params, hbm_capacity_bytes: int,
                 kv_reserve_bytes: int = 0,
                 store: Optional[ExpertStore] = None,
                 max_inflight_prefetch: int = 2, device=None):
        """``kv_reserve_bytes`` carves a slice of the HBM tier out of the
        weight cache for the engine's paged KV pool (``self.hbm_budget``).
        ``device`` defaults to the card and raises where there is none."""
        if not 0 <= kv_reserve_bytes < hbm_capacity_bytes:
            raise ValueError(
                f"kv_reserve_bytes={kv_reserve_bytes} must be in "
                f"[0, hbm_capacity_bytes={hbm_capacity_bytes})")
        self.device = resolve_device(device)
        self.router = router
        self.router_params = router_params
        self.experts: Dict[str, ExpertHandle] = {}
        self._models: Dict[str, Any] = {}
        self.store = store if store is not None else HostMemoryStore()
        self.hbm_budget = HBMBudget(
            total_bytes=hbm_capacity_bytes,
            weights_bytes=hbm_capacity_bytes - kv_reserve_bytes,
            kv_bytes=kv_reserve_bytes)
        self.cache = HBMWeightCache(self.hbm_budget.weights_bytes,
                                    store=self.store, device=self.device,
                                    max_inflight=max_inflight_prefetch)

    def register(self, handle: ExpertHandle):
        if handle.name in self.experts:
            raise KeyError(f"duplicate expert {handle.name}")
        if handle.host_params is not None:
            handle.nbytes                  # prime the size contract
            self.store.put(handle.name, handle.host_params)
            handle.host_params = None      # the store owns the copy now
        elif not self.store.contains(handle.name):
            raise KeyError(
                f"expert {handle.name}: no host_params given and not "
                f"present in the capacity-tier store")
        else:
            handle.__dict__["nbytes"] = self.store.nbytes(handle.name)
        self.experts[handle.name] = handle
        self._models[handle.name] = get_model(handle.cfg)

    def memory_contract(self, name: str) -> Dict[str, int]:
        h = self.experts[name]
        return {"hbm_bytes": h.nbytes,
                "ddr_bytes": self.store.stored_bytes(name)}

    def expert_names(self) -> List[str]:
        return list(self.experts.keys())

    def route(self, tokens) -> np.ndarray:
        return np.asarray(self.router.route(self.router_params, tokens))

    def route_request(self, tokens) -> tuple:
        """Route ONE prompt ``(S,)`` to an expert name; returns
        ``(name, seconds)``."""
        t0 = time.perf_counter()
        names = self.expert_names()
        e = int(self.route(np.asarray(tokens)[None])[0]) % len(names)
        return names[e], time.perf_counter() - t0

    def generate(self, tokens: np.ndarray, n_tokens: int, *,
                 prefetch_next: bool = True) -> GenerationResult:
        """tokens (B,S) int. Each prompt may route to a different expert;
        prompts are grouped per expert in stable order and each group runs
        in turn (prefill, then greedy ``decode_step``s on a dense cache of
        S + n_tokens positions), with the next group's expert prefetched
        while the current group runs."""
        names = self.expert_names()
        t0 = time.perf_counter()
        eidx = self.route(tokens) % len(names)
        route_s = time.perf_counter() - t0

        order = np.argsort(eidx, kind="stable")
        groups: List[tuple] = []
        for e in np.unique(eidx[order]):
            groups.append((int(e), np.where(eidx == e)[0]))

        B, S = tokens.shape
        out = np.zeros((B, n_tokens), np.int32)
        switch_s = 0.0
        exec_s = 0.0
        for gi, (e, rows) in enumerate(groups):
            name = names[e]
            t0 = time.perf_counter()
            params = self.cache.activate(name)
            switch_s += time.perf_counter() - t0

            if prefetch_next and gi + 1 < len(groups):
                self.cache.prefetch(names[groups[gi + 1][0]])

            model = self._models[name]
            sub = torch.as_tensor(np.asarray(tokens)[rows],
                                  device=self.device).long()
            t0 = time.perf_counter()
            last, cache = model.prefill(params, {"tokens": sub},
                                        max_len=S + n_tokens)
            tok = last.argmax(-1)
            toks = [tok]
            for t in range(n_tokens - 1):
                lg, cache = model.decode_step(params, cache, tok[:, None],
                                              S + t)
                tok = lg.argmax(-1)
                toks.append(tok)
            seq = torch.stack(toks, dim=1).cpu().numpy()
            exec_s += time.perf_counter() - t0
            out[rows] = seq
            del cache
        return GenerationResult(out, switch_s, exec_s, route_s, eidx)

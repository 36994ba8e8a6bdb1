"""Depth-extrapolated dry-run costs (counterpart of ``repro.launch.loopfix``).

The dry-run (``launch.dryrun``) traces a step on fake tensors and counts
every local op it runs. The port's layer loops, attention, the mLSTM's
chunk loop and the sLSTM's step loop are Python loops and kernel calls:
the trace sees every iteration, and each kernel call's cost function
counts its whole work. So no loop body is counted once, and JAX's
``inner_corrections`` (the analytic flops and bytes that XLA's cost
analysis misses inside a while-loop) has nothing to add here; it is not
carried over. ``tests/test_torch_dryrun.py`` shows that the trace at full
depth equals the extrapolation below.

What stays is the two-point extrapolation: the same cell traced at 1 and
2 layer units, cost(u) = outside + u * body, evaluated at the arch's true
units. It keeps an 80-layer model's trace to two short ones, and xLSTM's
sLSTM, which steps once per position, to one and two groups.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.configs.base import ModelConfig, ShapeCell


def unit_counts(cfg: ModelConfig) -> float:
    """True number of layer units of ``cfg`` (per family, JAX's)."""
    if cfg.family in ("dense", "moe"):
        return cfg.n_layers
    if cfg.family == "mla_moe":
        return cfg.n_layers - cfg.first_dense_layers  # dense head: outside
    if cfg.family == "encdec":
        return cfg.n_layers                  # encoder and decoder together
    if cfg.family == "rglru":
        plen = len(cfg.block_pattern)
        groups = cfg.n_layers // plen
        tail = cfg.n_layers % plen
        return groups + (tail / plen)        # the tail ~ a fraction of a group
    if cfg.family == "xlstm":
        return cfg.n_layers // cfg.slstm_every
    raise KeyError(cfg.family)


def reduced_depth_cfg(cfg: ModelConfig, units: int) -> ModelConfig:
    """``cfg`` cut to ``units`` layer units (JAX's cut)."""
    if cfg.family in ("dense", "moe"):
        return dataclasses.replace(cfg, n_layers=units)
    if cfg.family == "mla_moe":
        return dataclasses.replace(cfg,
                                   n_layers=cfg.first_dense_layers + units)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=units,
                                   n_encoder_layers=units)
    if cfg.family == "rglru":
        return dataclasses.replace(cfg,
                                   n_layers=len(cfg.block_pattern) * units)
    if cfg.family == "xlstm":
        return dataclasses.replace(cfg, n_layers=cfg.slstm_every * units)
    raise KeyError(cfg.family)


def extrapolate(c1: Dict[str, float], c2: Dict[str, float], units: float,
                keys=("flops", "bytes", "coll")) -> Dict[str, float]:
    """outside + units * body for each of ``keys``, body = c2 - c1 and
    outside = c1 - body (each at least 0), with both parts."""
    out = {}
    for k in keys:
        body = max(c2[k] - c1[k], 0.0)
        outside = max(c1[k] - body, 0.0)
        out[k] = outside + units * body
        out[f"{k}_body"] = body
        out[f"{k}_outside"] = outside
    return out


def corrected_cell_costs(cfg: ModelConfig, cell: ShapeCell, multi_pod: bool,
                         trace_fn: Callable) -> Dict[str, float]:
    """``trace_fn(cfg, cell, multi_pod)`` -> per-device ``flops``,
    ``bytes``, ``coll`` (and ``chips``) of one trace. Returns the
    per-device totals extrapolated from 1 and 2 units of ``cfg`` to its
    ``unit_counts``, with each term's body and outside and the units."""
    c1 = trace_fn(reduced_depth_cfg(cfg, 1), cell, multi_pod)
    c2 = trace_fn(reduced_depth_cfg(cfg, 2), cell, multi_pod)
    units = unit_counts(cfg)
    out = extrapolate(c1, c2, units)
    out["units"] = units
    out["chips"] = c1.get("chips", 1)
    return out

"""Param-spec machinery (counterpart of ``repro.models.common``).

Models declare their parameters as a nested dict of :class:`ParamSpec`;
``init_params`` materialises it with the JAX package's rule: normal scaled by
1/sqrt(fan_in), or zeros, or ones. The numbers differ from ``jax.random``'s;
parity tests hand both packages the same numpy arrays through ``bridge``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[str, ...]
    init: str = "normal"               # 'normal' | 'zeros' | 'ones'
    fan_in_axes: Tuple[int, ...] = ()


def spec(shape, axes, dtype=torch.bfloat16, init="normal", fan_in_axes=None):
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    if fan_in_axes is None:
        fan_in_axes = tuple(range(len(shape) - 1)) if init == "normal" else ()
    return ParamSpec(shape, dtype, axes, init, tuple(fan_in_axes))


def _spec_leaves(specs, prefix=""):
    if isinstance(specs, ParamSpec):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from _spec_leaves(specs[k], f"{prefix}/{k}" if prefix else k)


def init_params(specs, generator: torch.Generator, device):
    """Materialise ``specs`` on ``device``, drawing from ``generator`` leaf by
    leaf in sorted key order (deterministic for a seeded generator on the
    same device type)."""
    out = {}
    for path, s in _spec_leaves(specs):
        if s.init == "zeros":
            t = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=s.dtype, device=device)
        else:
            fan_in = int(np.prod([s.shape[i] for i in s.fan_in_axes])) or 1
            t = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                            device=device)
            t = t.mul_(1.0 / np.sqrt(fan_in)).to(s.dtype)
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


def param_bytes(specs) -> int:
    return int(sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
                   .element_size() for _, s in _spec_leaves(specs)))

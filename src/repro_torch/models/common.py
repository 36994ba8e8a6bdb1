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


def abstract_params(specs):
    """The tree of ``specs`` with each leaf a meta-device tensor of its
    shape and dtype: allocates nothing (JAX's ``ShapeDtypeStruct`` tree)."""
    if isinstance(specs, ParamSpec):
        return torch.empty(specs.shape, dtype=specs.dtype, device="meta")
    return {k: abstract_params(v) for k, v in specs.items()}


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


def unstack(tree):
    """The slices of a stacked tree along its leading axis, one tree an
    index: views (``unbind``), whose gradients the backward stacks in one
    op. Indexing each slice instead (``t[i]``) makes each one's gradient a
    zero-filled copy of the whole stack, L of them summed for L slices."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, or, with ``remat`` under grad mode, the same through
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept but recomputed in the backward (JAX's ``jax.checkpoint`` of a
    layer's body under ``remat=True``)."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def param_count(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for _, s in _spec_leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
                   .element_size() for _, s in _spec_leaves(specs)))

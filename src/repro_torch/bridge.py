"""Parameter trees between the JAX package and the port, through numpy.

The JAX package's params are nested dicts of arrays with layer params stacked
on a leading L axis (``layers/attn/wq`` is ``(L, D, Hq, dh)``). The port keeps
the same keys, shapes and layout, so a tree handed over as numpy arrays
(``jax.tree.map(np.asarray, params)``) converts leaf by leaf.

A JAX bfloat16 leaf arrives in numpy as an ``ml_dtypes`` bfloat16 array
(``dtype.str == "<V2"``), which ``torch.from_numpy`` refuses; it goes through
its 16-bit pattern instead, so the conversion is bit-exact both ways.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        out = []
        for v in tree.values():
            out.extend(tree_leaves(v))
        return out
    return [tree]


def tree_bytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.str == "<V2" and a.dtype.name == "bfloat16"


def array_to_tensor(a, device=None) -> torch.Tensor:
    a = np.array(a, order="C", copy=True)     # owned and writable
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def to_torch(tree: Any, device=None):
    """numpy (or array-like) tree -> torch tree on ``device`` (CPU copy when
    ``device`` is None)."""
    return tree_map(lambda a: array_to_tensor(a, device), tree)


def to_numpy(tree: Any):
    """torch tree -> numpy tree; bf16 leaves come back as ``ml_dtypes``
    bfloat16 arrays, as JAX hands them out."""
    return tree_map(tensor_to_array, tree)

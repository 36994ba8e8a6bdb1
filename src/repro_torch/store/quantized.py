"""Int8 block-quantized capacity tier (counterpart of
``repro.store.quantized``): about 2x (bf16) to 4x (f32) the experts a
capacity tier holds.

Each float leaf is flattened, split into blocks of ``block_size`` elements
and stored as int8 codes plus one f32 scale a block (absmax quantization):
``scale = absmax / 127`` (1.0 where the block is all zeros) and ``code =
clip(round(x / scale), -127, 127)``, rounding half to even as ``np.rint``
does, so codes and scales are bit-identical to JAX's. ``get`` dequantizes
on the host (``code * scale`` in f32, rounded to the leaf's dtype) inside a
``dequant`` span; non-float leaves pass through unchanged.

Per element: 1 byte of code and 4 / ``block_size`` of scale against 4 (f32)
or 2 (bf16) bytes; ``stored_bytes`` against ``nbytes`` reports it. The
error is at most scale / 2 = absmax / 254 a block. ``put`` always
quantizes, so a dirty write-back through this store round-trips lossily:
keep mutable state on the host or mmap store.

``put`` quantizes on whatever device the tree lies on (the card, where an
expert is built there) and keeps the codes and scales in host memory.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.bridge import tree_map
from repro_torch.obs import trace
from repro_torch.store.base import ExpertStore, host_tree_bytes


class _QLeaf:
    __slots__ = ("codes", "scales", "n", "shape", "dtype")

    def __init__(self, codes, scales, n, shape, dtype):
        self.codes = codes          # (n_blocks, block) int8
        self.scales = scales        # (n_blocks, 1) f32
        self.n = n                  # valid element count
        self.shape = shape
        self.dtype = dtype

    @property
    def stored(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())


def _quantize(t: torch.Tensor, block: int) -> _QLeaf:
    flat = t.detach().reshape(-1).to(torch.float32)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    scales = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scales = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(blocks / scales), -127, 127).to(
        torch.int8)
    return _QLeaf(codes.cpu(), scales.cpu(), n, tuple(t.shape), t.dtype)


def _dequantize(q: _QLeaf) -> torch.Tensor:
    flat = (q.codes.to(torch.float32) * q.scales).reshape(-1)[: q.n]
    return flat.reshape(q.shape).to(q.dtype)


class Int8BlockQuantizedStore(ExpertStore):
    """Host-memory backend holding int8-quantized expert trees."""

    def __init__(self, block_size: int = 64):
        super().__init__()
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block = block_size
        self._trees: Dict[str, Any] = {}
        self._nbytes: Dict[str, int] = {}
        self._stored: Dict[str, int] = {}

    def put(self, name, tree):
        stored = 0

        def enc(t):
            nonlocal stored
            t = torch.as_tensor(t)
            if not t.is_floating_point():
                t = t.detach().cpu()
                stored += t.numel() * t.element_size()
                return t
            q = _quantize(t, self.block)
            stored += q.stored
            return q

        self._trees[name] = tree_map(enc, tree)
        self._nbytes[name] = host_tree_bytes(tree)
        self._stored[name] = stored
        self._note_write(stored)

    def get(self, name):
        qtree = self._trees[name]
        with trace.span("dequant", cat="store", expert=name,
                        stored_bytes=self._stored[name]):
            tree = tree_map(
                lambda x: _dequantize(x) if isinstance(x, _QLeaf) else x,
                qtree)
        self._note_read(self._stored[name])
        return tree

    def contains(self, name):
        return name in self._trees

    def delete(self, name):
        del self._trees[name]
        del self._nbytes[name]
        del self._stored[name]

    def keys(self):
        return list(self._trees.keys())

    def nbytes(self, name):
        return self._nbytes[name]

    def stored_bytes(self, name):
        return self._stored[name]

    def compression_ratio(self, name: str) -> float:
        return self._nbytes[name] / max(self._stored[name], 1)

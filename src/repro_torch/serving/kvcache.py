"""Paged KV-cache pool (counterpart of ``repro.serving.kvcache.PagedKVCache``).

Requests allocate fixed-size blocks on demand and free them on completion;
block tables map each request's positions to pool rows. The pools are torch
tensors of shape ``(L, rows, block, Hkv, dh)`` on the serving device; with
``scratch=True`` one extra row (``scratch_index``) is never allocated, and
inactive decode lanes scatter there.

Host path: ``open/append/gather/free``. Device path: the decode step
scatters new K/V straight into ``self.k/self.v`` (in place) after
``reserve``, and the engine commits with ``advance``.

Every allocated block carries a refcount, audited by ``check_invariants``.
The prefix-sharing half of the JAX pool (``PrefixIndex``, adoption,
``pin``/``unpin``, copy-on-write splits, reclaimers) is not ported yet
(``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass
class PagedStats:
    allocs: int = 0
    frees: int = 0
    blocks_in_use: int = 0
    peak_blocks: int = 0

    def as_dict(self):
        return asdict(self)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PagedKVCache:
    """Block-paged K/V pool. Layout: (L, rows, block, kv_heads, head_dim)."""

    def __init__(self, n_blocks: int, block_size: int, n_layers: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 scratch: bool = False, device=None):
        """``device`` defaults to the card and raises where there is none;
        pass ``"cpu"`` for a host pool."""
        self.n_blocks = n_blocks
        self.block = block_size
        rows = n_blocks + (1 if scratch else 0)
        self.k = torch.zeros((n_layers, rows, block_size, kv_heads, head_dim),
                             dtype=dtype, device=resolve_device(device))
        self.v = torch.zeros_like(self.k)
        self.scratch_index = n_blocks if scratch else None
        self._free: List[int] = list(range(n_blocks))[::-1]
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        self._refs: Dict[int, int] = {}
        # monotonic versions of the host bookkeeping: device-copy caches
        # (engine._DeviceTableCache) re-upload only when these move
        self.table_version = 0
        self.length_version = 0
        self.stats = PagedStats()

    # -- sizing ------------------------------------------------------------
    @staticmethod
    def block_bytes(block_size: int, n_layers: int, kv_heads: int,
                    head_dim: int, dtype=torch.bfloat16) -> int:
        """Bytes of one K+V block across all layers."""
        return 2 * n_layers * block_size * kv_heads * head_dim * _itemsize(dtype)

    @classmethod
    def for_budget(cls, budget_bytes: int, block_size: int, n_layers: int,
                   kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                   scratch: bool = False, device=None) -> "PagedKVCache":
        """Largest pool whose K+V arrays fit in ``budget_bytes``; the scratch
        row counts against the budget."""
        per = cls.block_bytes(block_size, n_layers, kv_heads, head_dim, dtype)
        n_blocks = int(budget_bytes // per) - (1 if scratch else 0)
        if n_blocks < 1:
            raise MemoryError(
                f"KV budget {budget_bytes} bytes < "
                f"{'scratch + ' if scratch else ''}one block ({per} bytes)")
        return cls(n_blocks, block_size, n_layers, kv_heads, head_dim, dtype,
                   scratch=scratch, device=device)

    # -- bookkeeping -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def _per_block_bytes(self) -> int:
        L, _, blk, H, dh = self.k.shape
        return self.block_bytes(blk, L, H, dh, self.k.dtype)

    def capacity_bytes(self) -> int:
        """Bytes of the allocatable blocks (scratch row excluded)."""
        return self.n_blocks * self._per_block_bytes()

    def table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def padded_table(self, rid: int, max_blocks: int) -> np.ndarray:
        """(max_blocks,) int32 block table padded with the scratch index (or
        block 0 when no scratch row exists)."""
        pad = self.scratch_index if self.scratch_index is not None else 0
        tbl = self._tables[rid]
        out = np.full((max_blocks,), pad, np.int32)
        out[: len(tbl)] = tbl
        return out

    def length(self, rid: int) -> int:
        return self._lengths[rid]

    def live_table_refs(self) -> int:
        return sum(len(t) for t in self._tables.values())

    def check_invariants(self) -> List[str]:
        """Audit the refcount books; returns violations (empty = healthy)."""
        problems: List[str] = []
        if len(self._refs) + len(self._free) != self.n_blocks:
            problems.append(
                f"partition broken: {len(self._refs)} refcounted + "
                f"{len(self._free)} free != {self.n_blocks} blocks")
        if self.stats.blocks_in_use != len(self._refs):
            problems.append(
                f"stats drift: blocks_in_use={self.stats.blocks_in_use} "
                f"!= {len(self._refs)} refcounted blocks")
        refsum = sum(self._refs.values())
        live = self.live_table_refs()
        if refsum < live:
            problems.append(
                f"refcount sum {refsum} < {live} live table references")
        bad = [b for b in self._refs if not 0 <= b < self.n_blocks]
        if bad:
            problems.append(f"refcounted blocks outside pool: {bad}")
        nonpos = [b for b, r in self._refs.items() if r <= 0]
        if nonpos:
            problems.append(f"non-positive refcounts on blocks: {nonpos}")
        return problems

    # -- refcounting -------------------------------------------------------
    def _alloc_block(self) -> int:
        if not self._free:
            raise MemoryError("KV pool exhausted")
        blk = self._free.pop()
        self._refs[blk] = 1
        self.stats.allocs += 1
        self.stats.blocks_in_use += 1
        self.stats.peak_blocks = max(self.stats.peak_blocks,
                                     self.stats.blocks_in_use)
        return blk

    def _decref(self, blk: int) -> None:
        r = self._refs[blk] - 1
        if r == 0:
            del self._refs[blk]
            self._free.append(blk)
            self.stats.frees += 1
            self.stats.blocks_in_use -= 1
        else:
            self._refs[blk] = r

    # -- allocation ---------------------------------------------------------
    def open(self, rid: int):
        if rid in self._tables:
            raise KeyError(f"request {rid} already open")
        self._tables[rid] = []
        self._lengths[rid] = 0
        self.table_version += 1
        self.length_version += 1

    def _ensure(self, rid: int, n_tokens: int):
        need_blocks = -(-(self._lengths[rid] + n_tokens) // self.block)
        while len(self._tables[rid]) < need_blocks:
            self._tables[rid].append(self._alloc_block())
            self.table_version += 1

    def reserve(self, rid: int, n_tokens: int):
        """Grow the block table so ``n_tokens`` more tokens fit."""
        self._ensure(rid, n_tokens)

    def advance(self, rid: int, n_tokens: int):
        """Commit ``n_tokens`` tokens the decode step wrote on the device."""
        need = -(-(self._lengths[rid] + n_tokens) // self.block)
        if need > len(self._tables[rid]):
            raise RuntimeError(
                f"advance({rid}, {n_tokens}) beyond reserved blocks")
        self._lengths[rid] += n_tokens
        self.length_version += 1

    def append(self, rid: int, k_new, v_new):
        """k_new/v_new (L, n_tokens, kv_heads, head_dim) for one request."""
        n = k_new.shape[1]
        self._ensure(rid, n)
        start = self._lengths[rid]
        toks = np.arange(start, start + n)
        blks = np.asarray(self._tables[rid], np.int64)[toks // self.block]
        offs = toks % self.block
        idx = (torch.as_tensor(blks, device=self.k.device),
               torch.as_tensor(offs, device=self.k.device))
        self.k[:, idx[0], idx[1]] = k_new.to(self.k.dtype)
        self.v[:, idx[0], idx[1]] = v_new.to(self.v.dtype)
        self._lengths[rid] = start + n
        self.length_version += 1

    def gather(self, rid: int):
        """Contiguous (L, len, kv_heads, head_dim) copies for attention."""
        tbl = torch.as_tensor(self._tables[rid], dtype=torch.long,
                              device=self.k.device)
        L = self.k.shape[0]
        k = self.k[:, tbl].reshape(L, -1, *self.k.shape[3:])
        v = self.v[:, tbl].reshape(L, -1, *self.v.shape[3:])
        n = self._lengths[rid]
        return k[:, :n], v[:, :n]

    def free(self, rid: int):
        """Drop the request's references; blocks whose refcount reaches zero
        return to the free list. Both versions are bumped first, so a stale
        device-table snapshot can never gather rows a later request reuses."""
        tbl = self._tables.pop(rid)
        del self._lengths[rid]
        self.table_version += 1
        self.length_version += 1
        for blk in tbl:
            self._decref(blk)

"""Paged KV-cache pool (counterpart of ``repro.serving.kvcache.PagedKVCache``).

Requests allocate fixed-size blocks on demand and free them on completion;
block tables map each request's positions to pool rows. The pools are torch
tensors of shape ``(L, rows, block, Hkv, dh)`` on the serving device; with
``scratch=True`` one extra row (``scratch_index``) is never allocated, and
inactive decode lanes scatter there.

Host path: ``open/append/gather/free``. Device path: the decode step
scatters new K/V straight into ``self.k/self.v`` (in place) after
``reserve``, and the engine commits with ``advance``.

Copy-on-write prefix sharing: every allocated block carries a refcount,
one per block table that holds it plus one per ``PrefixIndex`` entry and
pin, audited by ``check_invariants`` (the watchdog samples it).
``open(rid, adopt=...)`` seats a request on blocks another request (or the
index) owns; shared blocks are read-only, and the first write into a shared,
partly filled tail (``reserve``/``append``) splits it: a fresh block, the
rows copied on the device in place, the table entry swapped
(``_make_tail_writable``). ``free`` releases only blocks whose refcount
reaches zero. When the free list runs dry the pool asks its reclaimers
(session retention, the prefix index) for blocks before it raises
``MemoryError``. The counters are a view over a metrics registry (``kv.*``
series, JAX's names).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import flightrec
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.stats import StatsView, counter_field, gauge_field


class PagedStats(StatsView):
    """KV-pool counters as a view over the metrics registry (``kv.*``).
    ``shared_blocks`` gauges the physical blocks backing more than one
    reference; ``cow_splits`` counts copy-on-write splits."""

    PREFIX = "kv"

    allocs = counter_field()
    frees = counter_field()
    blocks_in_use = gauge_field()
    peak_blocks = gauge_field()
    shared_blocks = gauge_field()
    cow_splits = counter_field()


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PagedKVCache:
    """Block-paged K/V pool. Layout: (L, rows, block, kv_heads, head_dim).

    ``shard_heads(n)`` stores the pool head-sharded for a tensor-parallel
    group of ``n`` ranks: physically ``(n, L, rows, block, kv_heads / n,
    head_dim)``, rank-major, so each rank's pool (``head_shard(k, r)``) is
    one contiguous array, as each socket holds its own KV shard. ``k`` and
    ``v`` are then the 6-D views ``(L, rows, block, n, kv_heads / n,
    head_dim)`` of that storage; every method here takes and returns K/V in
    the 5-D layout either way."""

    def __init__(self, n_blocks: int, block_size: int, n_layers: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 scratch: bool = False, device=None,
                 registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Dict[str, Any]] = None):
        """``device`` defaults to the card and raises where there is none;
        pass ``"cpu"`` for a host pool. ``registry``/``labels`` publish the
        ``kv.*`` counters (a private registry when omitted)."""
        self.n_blocks = n_blocks
        self.block = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.head_shards = 1
        rows = n_blocks + (1 if scratch else 0)
        self.k = torch.zeros((n_layers, rows, block_size, kv_heads, head_dim),
                             dtype=dtype, device=resolve_device(device))
        self.v = torch.zeros_like(self.k)
        self.scratch_index = n_blocks if scratch else None
        self._free: List[int] = list(range(n_blocks))[::-1]
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        self._refs: Dict[int, int] = {}       # block -> reference count
        # holders of speculative blocks (SessionManager, PrefixIndex) with
        # reclaim(need) -> int and reclaimable() -> int, in registration order
        self._reclaimers: List[Any] = []
        # monotonic versions of the host bookkeeping: device-copy caches
        # (engine._DeviceTableCache) re-upload only when these move
        self.table_version = 0
        self.length_version = 0
        self.stats = PagedStats(registry=registry, labels=labels)

    # -- sizing ------------------------------------------------------------
    @staticmethod
    def block_bytes(block_size: int, n_layers: int, kv_heads: int,
                    head_dim: int, dtype=torch.bfloat16) -> int:
        """Bytes of one K+V block across all layers."""
        return 2 * n_layers * block_size * kv_heads * head_dim * _itemsize(dtype)

    @classmethod
    def for_budget(cls, budget_bytes: int, block_size: int, n_layers: int,
                   kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                   scratch: bool = False, device=None,
                   registry: Optional[MetricsRegistry] = None,
                   labels: Optional[Dict[str, Any]] = None
                   ) -> "PagedKVCache":
        """Largest pool whose K+V arrays fit in ``budget_bytes``; the scratch
        row counts against the budget."""
        per = cls.block_bytes(block_size, n_layers, kv_heads, head_dim, dtype)
        n_blocks = int(budget_bytes // per) - (1 if scratch else 0)
        if n_blocks < 1:
            raise MemoryError(
                f"KV budget {budget_bytes} bytes < "
                f"{'scratch + ' if scratch else ''}one block ({per} bytes)")
        return cls(n_blocks, block_size, n_layers, kv_heads, head_dim, dtype,
                   scratch=scratch, device=device, registry=registry,
                   labels=labels)

    # -- bookkeeping -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def _per_block_bytes(self) -> int:
        return self.block_bytes(self.block, self.k.shape[0], self.kv_heads,
                                self.head_dim, self.k.dtype)

    def shard_heads(self, n: int) -> None:
        """Store the (still empty) pool head-sharded over ``n`` ranks (see
        the class docstring); ``n`` must divide the kv heads."""
        if self._tables:
            raise RuntimeError("shard_heads: the pool holds requests")
        if self.kv_heads % n:
            raise ValueError(f"{n} ranks do not divide {self.kv_heads} kv "
                             "heads")
        L, rows = self.k.shape[:2]
        shape = (n, L, rows, self.block, self.kv_heads // n, self.head_dim)
        dev, dt = self.k.device, self.k.dtype
        self.k = self.v = None
        self.k = torch.zeros(shape, dtype=dt, device=dev).permute(
            1, 2, 3, 0, 4, 5)
        self.v = torch.zeros(shape, dtype=dt, device=dev).permute(
            1, 2, 3, 0, 4, 5)
        self.head_shards = n

    def write(self, rows, offs, k_new, v_new) -> None:
        """Land K/V (L, n, kv_heads, head_dim) at pool ``rows`` / ``offs``
        (each (n,), on the pool's device), in place."""
        shape = tuple(k_new.shape[:2]) + tuple(self.k.shape[3:])
        self.k[:, rows, offs] = k_new.reshape(shape).to(self.k.dtype)
        self.v[:, rows, offs] = v_new.reshape(shape).to(self.v.dtype)

    def capacity_bytes(self) -> int:
        """Bytes of the allocatable blocks (scratch row excluded)."""
        return self.n_blocks * self._per_block_bytes()

    def bytes_in_use(self) -> int:
        return self.stats.blocks_in_use * self._per_block_bytes()

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

    def refcount(self, blk: int) -> int:
        """Current reference count of one block (0 = on the free list)."""
        return self._refs.get(blk, 0)

    def live_table_refs(self) -> int:
        return sum(len(t) for t in self._tables.values())

    def open_rids(self) -> Tuple[int, ...]:
        return tuple(self._tables)

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

    # -- reclaim (KV pages vs sessions / the index) ------------------------
    def add_reclaimer(self, reclaimer: Any) -> None:
        """Register a holder of speculative blocks: ``reclaim(need_blocks)
        -> int`` frees at least that many if it can and returns how many it
        freed; ``reclaimable() -> int`` is a lower bound on what a reclaim
        could free. Consulted in registration order."""
        self._reclaimers.append(reclaimer)

    def reclaimable_blocks(self) -> int:
        """Blocks the reclaimers could free on demand (admission counts them
        beside ``free_blocks``)."""
        return sum(int(r.reclaimable()) for r in self._reclaimers)

    def _reclaim(self, need: int) -> None:
        """Ask the reclaimers for blocks until the free list covers ``need``,
        looping while any makes progress (evicting a leaf prefix entry can
        expose its parent)."""
        before = len(self._free)
        while len(self._free) < need:
            progress = 0
            for r in self._reclaimers:
                if len(self._free) >= need:
                    break
                progress += int(r.reclaim(need - len(self._free)))
            if progress == 0:
                break
        if len(self._free) != before:
            flightrec.record("reclaim", need=need,
                             freed=len(self._free) - before,
                             free_blocks=len(self._free))

    # -- refcounting -------------------------------------------------------
    def _alloc_block(self) -> int:
        if not self._free:
            self._reclaim(1)
        if not self._free:
            raise MemoryError("KV pool exhausted")
        blk = self._free.pop()
        self._refs[blk] = 1
        self.stats.allocs += 1
        self.stats.blocks_in_use += 1
        self.stats.peak_blocks = max(self.stats.peak_blocks,
                                     self.stats.blocks_in_use)
        return blk

    def _incref(self, blk: int) -> None:
        r = self._refs[blk]
        self._refs[blk] = r + 1
        if r == 1:
            self.stats.shared_blocks += 1

    def _decref(self, blk: int) -> None:
        r = self._refs[blk] - 1
        if r == 0:
            del self._refs[blk]
            self._free.append(blk)
            self.stats.frees += 1
            self.stats.blocks_in_use -= 1
        else:
            self._refs[blk] = r
            if r == 1:
                self.stats.shared_blocks -= 1

    def pin(self, blocks: Sequence[int]) -> None:
        """One extra reference on each block: keeps a matched prefix from a
        reclaim between ``PrefixIndex.match`` and the adopting ``open``.
        Pair with ``unpin``."""
        for b in blocks:
            self._incref(b)

    def unpin(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self._decref(b)

    # -- allocation ---------------------------------------------------------
    def open(self, rid: int, adopt: Optional[Sequence[int]] = None,
             adopt_len: int = 0):
        """Open a request's block table, empty or, with ``adopt`` /
        ``adopt_len``, seated on shared blocks that hold its first
        ``adopt_len`` tokens (each adopted block's refcount goes up; the
        first write into a partly filled shared tail splits it)."""
        if rid in self._tables:
            raise KeyError(f"request {rid} already open")
        blocks = [int(b) for b in (adopt or ())]
        if blocks:
            if not 0 < adopt_len <= len(blocks) * self.block:
                raise ValueError(
                    f"adopt_len={adopt_len} outside ({0}, "
                    f"{len(blocks) * self.block}]")
            if adopt_len <= (len(blocks) - 1) * self.block:
                raise ValueError(
                    f"adopt_len={adopt_len} leaves the last of "
                    f"{len(blocks)} adopted blocks unused")
            for b in blocks:
                if b not in self._refs:
                    raise ValueError(f"cannot adopt free block {b}")
            for b in blocks:
                self._incref(b)
        elif adopt_len:
            raise ValueError("adopt_len without adopted blocks")
        self._tables[rid] = blocks
        self._lengths[rid] = adopt_len if blocks else 0
        self.table_version += 1
        self.length_version += 1

    def _make_tail_writable(self, rid: int) -> None:
        """Copy-on-write split of a shared, partly filled tail block before a
        write: a fresh block gets its rows (copied on the device, in place),
        the table entry is swapped and the original loses one reference.
        Full adopted blocks never need it: writes land only at positions at
        or past the committed length."""
        n = self._lengths[rid]
        if n == 0 or n % self.block == 0:
            return
        bi = n // self.block
        tbl = self._tables[rid]
        old = tbl[bi]
        if self._refs[old] <= 1:
            return
        new = self._alloc_block()
        self.k[:, new] = self.k[:, old]
        self.v[:, new] = self.v[:, old]
        tbl[bi] = new
        self._decref(old)
        self.table_version += 1
        self.stats.cow_splits += 1

    def _ensure(self, rid: int, n_tokens: int):
        need_blocks = -(-(self._lengths[rid] + n_tokens) // self.block)
        while len(self._tables[rid]) < need_blocks:
            self._tables[rid].append(self._alloc_block())
            self.table_version += 1

    def reserve(self, rid: int, n_tokens: int):
        """Grow the block table so ``n_tokens`` more tokens fit. The step
        then scatters into the reserved positions on the device, which
        writes the tail block, so a shared tail is split here first."""
        self._make_tail_writable(rid)
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
        self._make_tail_writable(rid)
        self._ensure(rid, n)
        start = self._lengths[rid]
        toks = np.arange(start, start + n)
        blks = np.asarray(self._tables[rid], np.int64)[toks // self.block]
        offs = toks % self.block
        self.write(torch.as_tensor(blks, device=self.k.device),
                   torch.as_tensor(offs, device=self.k.device), k_new, v_new)
        self._lengths[rid] = start + n
        self.length_version += 1

    def gather(self, rid: int):
        """Contiguous (L, len, kv_heads, head_dim) copies for attention."""
        tbl = torch.as_tensor(self._tables[rid], dtype=torch.long,
                              device=self.k.device)
        shape = (self.k.shape[0], -1, self.kv_heads, self.head_dim)
        k = self.k[:, tbl].reshape(shape)
        v = self.v[:, tbl].reshape(shape)
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


def head_shard(pool_tensor, r: int):
    """Rank ``r``'s contiguous ``(L, rows, block, kv_heads / n, head_dim)``
    pool of a head-sharded pool's ``k`` or ``v`` (``shard_heads``)."""
    return pool_tensor.permute(3, 0, 1, 2, 4, 5)[r]


# ----------------------------------------------------------------------
# Radix-style prefix index over token-id block hashes
# ----------------------------------------------------------------------

@dataclass
class _PrefixEntry:
    key: bytes
    parent: bytes
    block: int
    tokens: np.ndarray                   # the block's token ids (<= block)
    last_use: int = 0
    n_children: int = field(default=0)


class PrefixIndex:
    """Radix-style prefix index over ``PagedKVCache`` blocks.

    Keys chain hashes of token-id blocks, ``key_i = H(key_{i-1} ||
    tokens_i)``, rooted at the expert's name (KV is valid only for the
    expert that produced it). ``insert`` indexes every full block of a
    finished sequence (one pool reference each, so the block outlives the
    request); ``match`` walks the chain over a new prompt and returns the
    shared blocks and the matched token count, possibly ending in a partial
    tail (an indexed block whose first tokens match: adopted, split on the
    adopter's first write). Stored token arrays are compared on every hop,
    so a hash collision is a miss, never a wrong adoption. A pool reclaimer:
    under pressure it evicts least-recently-used leaf entries that only it
    references."""

    def __init__(self, pool: PagedKVCache):
        self.pool = pool
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self._children: Dict[bytes, List[bytes]] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _root(expert: str) -> bytes:
        return b"root:" + expert.encode()

    @staticmethod
    def _key(parent: bytes, tokens: np.ndarray) -> bytes:
        return hashlib.blake2b(
            parent + np.ascontiguousarray(tokens, np.int32).tobytes(),
            digest_size=16).digest()

    # -- write path --------------------------------------------------------
    def insert(self, expert: str, tokens: np.ndarray,
               table: Sequence[int]) -> int:
        """Index the full blocks of a finished sequence (``tokens``: its
        first ``pool.length(rid)`` ids; ``table``: its block table). Returns
        the entries created; existing ones are refreshed, not re-referenced."""
        self._clock += 1
        B = self.pool.block
        key = self._root(expert)
        created = 0
        for i in range(min(len(tokens) // B, len(table))):
            blk_toks = np.ascontiguousarray(tokens[i * B:(i + 1) * B],
                                            np.int32)
            child = self._key(key, blk_toks)
            e = self._entries.get(child)
            if e is None:
                self.pool._incref(int(table[i]))
                e = _PrefixEntry(key=child, parent=key, block=int(table[i]),
                                 tokens=blk_toks)
                self._entries[child] = e
                self._children.setdefault(key, []).append(child)
                if key in self._entries:
                    self._entries[key].n_children += 1
                created += 1
            e.last_use = self._clock
            key = child
        return created

    # -- read path ---------------------------------------------------------
    def match(self, expert: str,
              tokens: np.ndarray) -> Optional[Tuple[List[int], int]]:
        """Longest indexed prefix of ``tokens`` for this expert:
        ``(blocks, n_tokens)`` with the blocks PINNED (the caller adopts,
        then unpins), or ``None``. Capped at ``len(tokens) - 1``, so at least
        one suffix token runs a forward (the first token needs logits)."""
        self._clock += 1
        B = self.pool.block
        key = self._root(expert)
        blocks: List[int] = []
        i = 0
        while (i + 1) * B <= len(tokens):
            blk_toks = np.ascontiguousarray(tokens[i * B:(i + 1) * B],
                                            np.int32)
            child = self._key(key, blk_toks)
            e = self._entries.get(child)
            if e is None or not np.array_equal(e.tokens, blk_toks):
                break
            e.last_use = self._clock
            blocks.append(e.block)
            key = child
            i += 1
        n = i * B
        rest = np.ascontiguousarray(tokens[n:], np.int32)
        if len(rest):
            # partial tail: an indexed child whose first tokens match
            best, best_m = None, 0
            for ck in self._children.get(key, ()):
                e = self._entries.get(ck)
                if e is None:
                    continue
                m = int((np.cumprod(e.tokens[:len(rest)]
                                    == rest[:len(e.tokens)])).sum())
                if m > best_m:
                    best, best_m = e, m
            if best is not None and best_m > 0:
                best.last_use = self._clock
                blocks.append(best.block)
                n += best_m
        if n >= len(tokens):            # keep >= 1 token for the forward
            n = len(tokens) - 1
            blocks = blocks[: -(-n // B)] if n else []
        if n == 0:
            self.misses += 1
            return None
        self.hits += 1
        self.pool.pin(blocks)
        return blocks, n

    # -- eviction / reclaim ------------------------------------------------
    def _evict(self, e: _PrefixEntry) -> None:
        del self._entries[e.key]
        sibs = self._children.get(e.parent)
        if sibs is not None:
            sibs.remove(e.key)
            if not sibs:
                del self._children[e.parent]
        p = self._entries.get(e.parent)
        if p is not None:
            p.n_children -= 1
        self.pool._decref(e.block)

    def _victims(self) -> List[_PrefixEntry]:
        """LRU-ordered leaf entries whose block only the index references:
        evicting anything else frees nothing (a shared block) or strands
        reachable children (an interior entry)."""
        return sorted((e for e in self._entries.values()
                       if e.n_children == 0
                       and self.pool.refcount(e.block) == 1),
                      key=lambda e: e.last_use)

    def reclaimable(self) -> int:
        return len(self._victims())

    def reclaim(self, need_blocks: int) -> int:
        freed = 0
        while freed < need_blocks:
            vs = self._victims()
            if not vs:
                break
            for e in vs:
                if freed >= need_blocks:
                    break
                self._evict(e)
                freed += 1
        return freed

    def clear(self) -> None:
        """Drop every entry and its pool reference."""
        while self._entries:
            for e in list(self._entries.values()):
                if e.n_children == 0:
                    self._evict(e)

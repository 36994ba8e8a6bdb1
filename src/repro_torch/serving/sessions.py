"""Multi-turn session KV retention over the paged pool.

A chat session's next turn re-sends the whole conversation so far; without
retention every turn re-prefills it. ``SessionManager`` keeps a finished
request's block table open in the pool (the rid stays seated, nothing is
copied) keyed by session id, and the next turn adopts the common prefix via
the same pin → ``open(adopt=)`` path a ``PrefixIndex`` hit uses.

Retained pages compete with expert weights for the HBM tier — exactly the
paper's three-tier tradeoff (§IV): the manager holds at most ``max_bytes``
of pages, evicts LRU-by-cost beyond that, and registers with the pool as a
*reclaimer* so admission pressure (new requests needing blocks) can force
sessions out. Every eviction lands in the ``TransferLedger``: blocks only
this session referenced are a ``writeback`` edge (those bytes would move to
a colder tier in a real system); blocks that survive via other references
(prefix index, concurrent requests) are ``elided`` — dropping a reference
moves no bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import flightrec
from repro_torch.serving.kvcache import PagedKVCache


@dataclass
class _Session:
    rid: int                  # the pool rid still holding the pages
    expert: str
    tokens: np.ndarray        # committed token ids, len == pool.length(rid)
    last_use: int = 0


class SessionManager:
    """LRU+cost retention of finished requests' KV pages, per session id."""

    def __init__(self, pool: PagedKVCache, ledger: Optional[Any] = None,
                 max_bytes: Optional[int] = None):
        self.pool = pool
        self.ledger = ledger
        # default: retained sessions may hold at most half the pool, so
        # fresh admissions always have headroom before reclaim kicks in
        self.max_bytes = (pool.capacity_bytes() // 2
                          if max_bytes is None else int(max_bytes))
        self._sessions: Dict[str, _Session] = {}
        self._clock = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, sid: str) -> bool:
        return sid in self._sessions

    def _bytes(self, s: _Session) -> int:
        return len(self.pool.table(s.rid)) * self.pool._per_block_bytes()

    def bytes_retained(self) -> int:
        return sum(self._bytes(s) for s in self._sessions.values())

    # -- write path --------------------------------------------------------
    def retain(self, sid: str, rid: int, expert: str,
               tokens: np.ndarray) -> None:
        """Keep ``rid``'s pages resident for the session's next turn. The
        manager takes over ownership of the rid — the engine must NOT call
        ``pool.free(rid)`` afterwards. A session's previous turn is evicted
        first (the new turn's pages subsume it)."""
        self._clock += 1
        if sid in self._sessions:
            self.evict(sid, cause="session_replace")
        self._sessions[sid] = _Session(
            rid=rid, expert=expert,
            tokens=np.ascontiguousarray(tokens[: self.pool.length(rid)],
                                        np.int32),
            last_use=self._clock)
        self._enforce_cap()

    # -- read path ---------------------------------------------------------
    def adopt(self, sid: str,
              expert: str,
              tokens: np.ndarray) -> Optional[Tuple[List[int], int]]:
        """Hand the session's pages to its next turn. Returns PINNED
        ``(blocks, n_tokens)`` covering the longest common prefix of the
        retained sequence and the new prompt (capped at ``len(tokens) - 1``
        so the suffix forward still produces logits), or ``None``. The
        retained rid is freed — adopted blocks survive through the pin, and
        a partially-consumed tail block stays position-exact (the adopter's
        first write COW-splits it if anything else still references it)."""
        s = self._sessions.get(sid)
        if s is None:
            return None
        if s.expert != expert:
            # routed to a different expert this turn: the KV is useless
            self.evict(sid, cause="session_reroute")
            return None
        new = np.ascontiguousarray(tokens, np.int32)
        m = min(len(s.tokens), len(new))
        n = int(np.cumprod(s.tokens[:m] == new[:m]).sum()) if m else 0
        n = min(n, len(new) - 1)
        if n <= 0:
            self.evict(sid, cause="session_mismatch")
            return None
        B = self.pool.block
        blocks = self.pool.table(s.rid)[: -(-n // B)]
        self.pool.pin(blocks)
        del self._sessions[sid]
        self.pool.free(s.rid)
        return blocks, n

    # -- eviction ----------------------------------------------------------
    def evict(self, sid: str, cause: str = "session_evict") -> int:
        """Release one session's pages. Returns blocks actually freed."""
        s = self._sessions.pop(sid)
        tbl = self.pool.table(s.rid)
        per = self.pool._per_block_bytes()
        orphan = sum(1 for b in tbl if self.pool.refcount(b) == 1)
        shared = len(tbl) - orphan
        if self.ledger is not None:
            if orphan:
                self.ledger.record("writeback", orphan * per, cause=cause)
            if shared:
                self.ledger.record("elided", shared * per, cause=cause)
        before = self.pool.free_blocks
        self.pool.free(s.rid)
        self.evictions += 1
        freed = self.pool.free_blocks - before
        flightrec.record("evict", sid=sid, rid=s.rid, expert=s.expert,
                         cause=cause, freed_blocks=freed)
        return freed

    def _victim(self) -> Optional[str]:
        """Highest age-per-byte session: old AND cheap-to-rebuild goes
        first; a long recent conversation (expensive to re-prefill) stays."""
        if not self._sessions:
            return None
        return max(self._sessions,
                   key=lambda sid: ((self._clock
                                     - self._sessions[sid].last_use)
                                    / max(len(self._sessions[sid].tokens), 1)))

    def _enforce_cap(self) -> None:
        while len(self._sessions) > 1 and self.bytes_retained() > self.max_bytes:
            self.evict(self._victim(), cause="session_cap")

    # -- pool reclaimer protocol -------------------------------------------
    def reclaimable(self) -> int:
        """Lower bound on blocks an eviction sweep would free (only blocks
        with no other reference actually return to the free list)."""
        return sum(1 for s in self._sessions.values()
                   for b in self.pool.table(s.rid)
                   if self.pool.refcount(b) == 1)

    def reclaim(self, need_blocks: int) -> int:
        freed = 0
        while freed < need_blocks and self._sessions:
            freed += self.evict(self._victim(), cause="session_pressure")
        return freed

    def evict_all(self, cause: str = "session_drain") -> None:
        while self._sessions:
            self.evict(next(iter(self._sessions)), cause=cause)

"""Asyncio streaming front door for the serving engine.

``ServingEngine`` is a synchronous single-thread scheduler — the right shape
for the decode loop, the wrong shape for a million concurrent users. This
module puts a front door on it:

  * **one pump thread owns the engine.** All engine access (submit, step,
    queue surgery) happens on that thread; callers talk to a thread-safe
    admission heap. The engine's ``on_token``/``on_done`` callbacks fire on
    the pump thread and only enqueue into per-request ``TokenStream``s, so
    the decode loop never blocks on a slow consumer.
  * **per-tenant quotas** at the door: a concurrency cap plus a token-bucket
    request rate. Over-quota submits raise ``QuotaExceeded`` immediately —
    load shedding happens before a request ever touches engine state.
  * **SLO-aware priority and preemption at admission**: the heap orders by
    (priority desc, TTFT deadline asc). The engine's own queue is kept
    short (``max_engine_queue``) so ordering decisions stay at the
    frontend; when a higher-priority request arrives, an unadmitted
    lower-priority request is pulled back out of the engine queue into the
    heap (``frontend.preemptions``). Requests already decoding are never
    preempted — their KV and slot investment is sunk.
  * **streaming**: tokens are observable as they are emitted, via the sync
    iterator ``TokenStream`` or an ``asyncio.Queue`` bridge
    (``stream_async``), plus a JSON-lines TCP server (``serve_tcp``) for
    real sockets.
"""
from __future__ import annotations

import asyncio
import heapq
import itertools
import json
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import flightrec
from repro_torch.serving.engine import Request, ServingEngine

_DONE = object()                         # TokenStream end-of-stream sentinel


class QuotaExceeded(Exception):
    """Tenant over its concurrency cap or request-rate bucket."""


@dataclass
class TenantQuota:
    """Admission limits for one tenant. ``requests_per_s=None`` disables
    rate limiting; ``burst`` is the token-bucket depth (defaults to the
    rate, min 1)."""

    max_concurrent: int = 8
    requests_per_s: Optional[float] = None
    burst: Optional[float] = None

    def bucket_depth(self) -> float:
        if self.requests_per_s is None:
            return float("inf")
        return max(self.burst if self.burst is not None
                   else self.requests_per_s, 1.0)


class _TenantState:
    def __init__(self, quota: TenantQuota):
        self.quota = quota
        self.inflight = 0
        self.tokens = quota.bucket_depth()
        self.last_refill = time.monotonic()

    def try_admit(self) -> bool:
        if self.inflight >= self.quota.max_concurrent:
            return False
        if self.quota.requests_per_s is not None:
            now = time.monotonic()
            self.tokens = min(
                self.quota.bucket_depth(),
                self.tokens + (now - self.last_refill)
                * self.quota.requests_per_s)
            self.last_refill = now
            if self.tokens < 1.0:
                return False
            self.tokens -= 1.0
        self.inflight += 1
        return True


class TokenStream:
    """Per-request stream of emitted token ids. Iterating blocks until the
    next token (or end of stream); ``drain()`` blocks to completion and
    returns everything at once."""

    def __init__(self, req: Request):
        self.request = req
        self._q: "queue.Queue[Any]" = queue.Queue()

    def _put(self, tok: int) -> None:
        self._q.put(tok)

    def _close(self) -> None:
        self._q.put(_DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            yield item

    def drain(self) -> List[int]:
        return list(self)


@dataclass(order=True)
class _Pending:
    # heap key: higher priority first, then earlier TTFT deadline, then FIFO
    sort_key: Tuple[int, float, int]
    req: Request = None                  # type: ignore[assignment]
    stream: TokenStream = None           # type: ignore[assignment]


class StreamingFrontend:
    """Thread-safe, quota-enforcing, SLO-ordered front door to one engine
    (or anything engine-shaped, e.g. an ``RDUNode`` via a thin adapter)."""

    def __init__(self, engine: ServingEngine, *,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 max_engine_queue: Optional[int] = None,
                 rid_base: int = 1_000_000):
        self.engine = engine
        self._default_quota = default_quota or TenantQuota()
        self._tenants: Dict[str, _TenantState] = {
            t: _TenantState(q) for t, q in (quotas or {}).items()}
        # short engine queue: ordering stays here, where priorities live
        self.max_engine_queue = (max_engine_queue
                                 if max_engine_queue is not None
                                 else engine.n_slots * 2)
        self._heap: List[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._seq = itertools.count()
        self._rids = itertools.count(rid_base)
        self._closed = False
        reg = engine._registry
        labels = engine._obs_labels
        self._m_submitted = reg.counter("frontend.submitted", labels=labels)
        self._m_rejected = reg.counter("frontend.rejected_quota",
                                       labels=labels)
        self._m_preempt = reg.counter("frontend.preemptions", labels=labels)
        self._m_streamed = reg.counter("frontend.streamed_tokens",
                                       labels=labels)
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="frontend-pump")
        self._thread.start()

    # -- client API --------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int, *,
               tenant: str = "default", session_id: Optional[str] = None,
               priority: int = 0,
               slo_ttft_s: Optional[float] = None,
               slo_tpot_s: Optional[float] = None) -> TokenStream:
        """Admit one request (quota check now, engine later) and return its
        token stream. Raises ``QuotaExceeded`` instead of queueing when the
        tenant is over its limits."""
        if self._closed:
            raise RuntimeError("frontend is closed")
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantState(self._default_quota)
            if not ts.try_admit():
                self._m_rejected.inc()
                raise QuotaExceeded(f"tenant {tenant!r} over quota")
            req = Request(rid=next(self._rids),
                          tokens=np.asarray(tokens, np.int32),
                          max_new_tokens=max_new_tokens,
                          session_id=session_id, tenant=tenant,
                          priority=priority, slo_ttft_s=slo_ttft_s,
                          slo_tpot_s=slo_tpot_s)
            stream = TokenStream(req)
            req.on_token = lambda r, t: (stream._put(t),
                                         self._m_streamed.inc())
            req.on_done = lambda r: self._on_done(r, stream)
            deadline = req.arrival_s + (slo_ttft_s if slo_ttft_s is not None
                                        else float("inf"))
            heapq.heappush(self._heap, _Pending(
                (-priority, deadline, next(self._seq)), req, stream))
            self._m_submitted.inc()
        self._wake.set()
        return stream

    def _on_done(self, req: Request, stream: TokenStream) -> None:
        with self._lock:
            ts = self._tenants.get(req.tenant)
            if ts is not None:
                ts.inflight -= 1
        stream._close()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has finished."""
        t0 = time.monotonic()
        while True:
            with self._lock:
                idle = not self._heap and not self.engine.has_work
            if idle:
                return True
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.001)

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=10)

    # -- pump thread (sole owner of the engine) ----------------------------
    def _pump(self) -> None:
        while not self._closed:
            moved = self._feed_engine()
            if self.engine.has_work:
                self.engine.step()
            elif not moved:
                self._wake.wait(timeout=0.01)
                self._wake.clear()

    def _feed_engine(self) -> int:
        """Move heap-ordered pending work into the engine queue, preempting
        unadmitted lower-priority engine entries when a higher-priority
        request would otherwise wait behind them."""
        moved = 0
        with self._lock:
            while self._heap:
                if len(self.engine.queue) >= self.max_engine_queue:
                    if not self._preempt_for(self._heap[0]):
                        break
                p = heapq.heappop(self._heap)
                self.engine.submit(p.req)
                moved += 1
        return moved

    def _preempt_for(self, cand: _Pending) -> bool:
        """Pull the lowest-priority *unadmitted* request back out of the
        engine queue to make room for ``cand`` — only if it is strictly
        lower priority. Decoding slots are untouched (sunk KV cost)."""
        q = self.engine.queue
        if not q:
            return False
        victim = min(q, key=lambda r: r.priority)
        if victim.priority >= cand.req.priority:
            return False
        q.remove(victim)
        victim.preemptions += 1          # lifecycle-plane attribution
        flightrec.record("preempt", rid=victim.rid, tenant=victim.tenant,
                         priority=victim.priority, by=cand.req.rid)
        heapq.heappush(self._heap, _Pending(
            (-victim.priority,
             victim.arrival_s + (victim.slo_ttft_s
                                 if victim.slo_ttft_s is not None
                                 else float("inf")),
             next(self._seq)),
            victim, None))
        self._m_preempt.inc()
        return True

    # -- asyncio bridge ----------------------------------------------------
    def stream_async(self, stream: TokenStream,
                     loop: Optional[asyncio.AbstractEventLoop] = None
                     ) -> "asyncio.Queue[Any]":
        """Bridge a TokenStream onto an asyncio.Queue (``None`` terminates).
        Must be called from the event loop thread (or pass ``loop``)."""
        loop = loop or asyncio.get_event_loop()
        aq: "asyncio.Queue[Any]" = asyncio.Queue()

        def rely():
            for tok in stream:
                loop.call_soon_threadsafe(aq.put_nowait, tok)
            loop.call_soon_threadsafe(aq.put_nowait, None)

        threading.Thread(target=rely, daemon=True).start()
        return aq

    async def handle_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        """One JSON-lines request per connection:
        ``{"tokens": [...], "max_new_tokens": n, "tenant": ..., ...}`` in,
        ``{"token": t}`` per emitted token and ``{"done": true, "output":
        [...]}`` (or ``{"error": ...}``) out."""
        try:
            line = await reader.readline()
            msg = json.loads(line)
            stream = self.submit(
                msg["tokens"], int(msg["max_new_tokens"]),
                tenant=msg.get("tenant", "default"),
                session_id=msg.get("session_id"),
                priority=int(msg.get("priority", 0)),
                slo_ttft_s=msg.get("slo_ttft_s"),
                slo_tpot_s=msg.get("slo_tpot_s"))
        except QuotaExceeded as e:
            writer.write(json.dumps({"error": str(e)}).encode() + b"\n")
            await writer.drain()
            writer.close()
            return
        aq = self.stream_async(stream, asyncio.get_running_loop())
        out = []
        while True:
            tok = await aq.get()
            if tok is None:
                break
            out.append(tok)
            writer.write(json.dumps({"token": tok}).encode() + b"\n")
            await writer.drain()
        writer.write(json.dumps({"done": True, "output": out}).encode()
                     + b"\n")
        await writer.drain()
        writer.close()

    async def serve_tcp(self, host: str = "127.0.0.1", port: int = 0):
        """Start the JSON-lines TCP server; returns the asyncio server
        (``server.sockets[0].getsockname()`` for the bound port)."""
        return await asyncio.start_server(self.handle_connection, host, port)

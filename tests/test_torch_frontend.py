"""The port's streaming front door over its serving engine (after
``tests/test_frontend.py``): streamed tokens equal each request's recorded
output, per-tenant quotas are enforced at the door, a higher priority pulls
back only unadmitted lower-priority requests, and a JSON-lines round trip
over a localhost TCP socket. The engine under it serves the reduced
backbone with prefix sharing on, on the CPU. Every join, read and thread
has a timeout, so a hang fails the test instead of stalling the suite."""
import asyncio
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro_torch.bridge import to_torch, tree_bytes
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.serving import (QuotaExceeded, ServingEngine,
                                 StreamingFrontend, TenantQuota)

TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def experts():
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    m = jax_get_model(jcfg)
    rng = jax.random.PRNGKey(0)
    trees = [to_torch(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                   m.init(jax.random.fold_in(rng, i))))
             for i in range(2)]
    return reduced(get_config("samba-coe-expert-7b")), trees


def mk_engine(experts):
    cfg, trees = experts
    nbytes = tree_bytes(trees[0])
    coe = CompositionOfExperts(HashRouter(len(trees)), None,
                               int(2.5 * nbytes), device="cpu")
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, t))
    return ServingEngine(coe, cfg, max_len=48, n_slots=2, block_size=8,
                         prefix_sharing=True, kv_dtype=torch.float32,
                         device="cpu")


def prompt(cfg, seed, n=10):
    return np.random.RandomState(seed).randint(
        1, cfg.vocab_size, (n,)).astype(np.int32)


def drained(stream):
    """The stream's tokens, read on a thread joined with a timeout."""
    out = []
    t = threading.Thread(target=lambda: out.extend(stream), daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), "stream did not end"
    return out


def test_streamed_tokens_match_request_output(experts):
    cfg, _ = experts
    fe = StreamingFrontend(mk_engine(experts))
    try:
        streams = [fe.submit(prompt(cfg, i), 4, tenant="t",
                             session_id=f"s{i % 2}") for i in range(3)]
        assert fe.join(timeout=TIMEOUT)
        for s in streams:
            got = drained(s)
            assert got == [int(t) for t in s.request.output]
            assert len(got) == 4
        assert fe._m_streamed.value == 12 and fe._m_submitted.value == 3
    finally:
        fe.close()
    assert not fe._thread.is_alive()
    fe.engine.release_shared()
    assert fe.engine.pool.stats.blocks_in_use == 0


def test_quota_concurrency_and_rate(experts):
    """Over-concurrency and over-rate submits raise ``QuotaExceeded`` at the
    door, before any engine state, and are counted."""
    cfg, _ = experts
    eng = mk_engine(experts)
    fe = StreamingFrontend(eng, quotas={
        "small": TenantQuota(max_concurrent=1),
        "slow": TenantQuota(max_concurrent=8, requests_per_s=0.001,
                            burst=1)})
    try:
        s1 = fe.submit(prompt(cfg, 0), 3, tenant="small")
        with pytest.raises(QuotaExceeded):
            fe.submit(prompt(cfg, 1), 3, tenant="small")
        drained(s1)                  # done: the concurrency slot returns
        assert fe.join(timeout=TIMEOUT)
        drained(fe.submit(prompt(cfg, 2), 3, tenant="small"))
        drained(fe.submit(prompt(cfg, 3), 3, tenant="slow"))   # bucket: 1
        with pytest.raises(QuotaExceeded):
            fe.submit(prompt(cfg, 4), 3, tenant="slow")        # empty
        assert fe._m_rejected.value == 2
        assert fe.join(timeout=TIMEOUT)
        assert eng.stats.requests == 3
    finally:
        fe.close()
    fe.close()
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(prompt(cfg, 5), 3)


def test_priority_preempts_unadmitted_only(experts):
    """A higher-priority submit pulls a lower-priority unadmitted request
    back out of the engine queue; equal priority never preempts; requests
    already decoding are untouched."""
    cfg, _ = experts
    eng = mk_engine(experts)
    fe = StreamingFrontend(eng, max_engine_queue=1)
    # park the pump so the engine queue stays observable; feed by hand
    fe.close()
    fe._closed = False
    busy = fe.submit(prompt(cfg, 9), 6, priority=0)
    fe._feed_engine()
    eng.step()                               # busy is admitted: decoding
    assert eng.queue == [] and any(s is not None for s in eng.slots)
    lo = fe.submit(prompt(cfg, 0), 2, priority=0)
    fe._feed_engine()                        # lo waits in the engine queue
    assert [r.priority for r in eng.queue] == [0]
    hi = fe.submit(prompt(cfg, 1), 2, priority=5)
    fe._feed_engine()                        # queue full: lo pulled back
    assert [r.priority for r in eng.queue] == [5]
    assert fe._m_preempt.value == 1 and lo.request.preemptions == 1
    assert busy.request.preemptions == 0
    hi2 = fe.submit(prompt(cfg, 2), 2, priority=5)
    fe._feed_engine()                        # equal priority: no preemption
    assert fe._m_preempt.value == 1
    fe._thread = threading.Thread(target=fe._pump, daemon=True)
    fe._thread.start()
    try:
        for s, n in ((busy, 6), (lo, 2), (hi, 2), (hi2, 2)):
            assert len(drained(s)) == n
        assert fe.join(timeout=TIMEOUT)
    finally:
        fe.close()


def test_tcp_roundtrip(experts):
    """JSON-lines over a localhost socket: one line per token, then a done
    line whose output equals the streamed tokens; an over-quota request
    gets an error line."""
    cfg, _ = experts
    fe = StreamingFrontend(mk_engine(experts),
                           quotas={"none": TenantQuota(max_concurrent=0)})

    async def ask(host, port, msg):
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout=TIMEOUT)
        writer.write(json.dumps(msg).encode() + b"\n")
        await writer.drain()
        toks, final = [], None
        while final is None:
            line = await asyncio.wait_for(reader.readline(), timeout=TIMEOUT)
            m = json.loads(line)
            if "token" in m:
                toks.append(m["token"])
            else:
                final = m
        writer.close()
        return toks, final

    async def roundtrip():
        server = await fe.serve_tcp()
        host, port = server.sockets[0].getsockname()[:2]
        try:
            ok = await ask(host, port, {
                "tokens": [int(t) for t in prompt(cfg, 7)],
                "max_new_tokens": 3, "tenant": "net",
                "session_id": "tcp"})
            refused = await ask(host, port, {
                "tokens": [1, 2, 3], "max_new_tokens": 2, "tenant": "none"})
        finally:
            server.close()
            await asyncio.wait_for(server.wait_closed(), timeout=TIMEOUT)
        return ok, refused

    try:
        (toks, final), (no_toks, err) = asyncio.run(
            asyncio.wait_for(roundtrip(), timeout=2 * TIMEOUT))
        assert final["done"] is True
        assert final["output"] == toks and len(toks) == 3
        assert no_toks == [] and "over quota" in err["error"]
    finally:
        fe.close()


def test_concurrent_submitters_keep_the_quota_books(experts):
    """More submitting threads than cores against one pump thread, with a
    short switch interval: every accepted stream ends with its request's
    output, every refusal is counted, and each tenant's in-flight count
    returns to 0 (a lost update under the lock would leave it off)."""
    import sys

    cfg, _ = experts
    eng = mk_engine(experts)
    fe = StreamingFrontend(eng, quotas={
        "a": TenantQuota(max_concurrent=3), "b": TenantQuota(max_concurrent=2)})
    accepted, refused = [], []
    lock = threading.Lock()

    def submitter(i):
        for j in range(2):
            try:
                st = fe.submit(prompt(cfg, 100 + 2 * i + j, n=6), 2,
                               tenant="ab"[i % 2], priority=i % 3)
                with lock:
                    accepted.append(st)
            except QuotaExceeded:
                with lock:
                    refused.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        for st in accepted:
            assert drained(st) == [int(t) for t in st.request.output]
        assert fe.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
        fe.close()
    assert len(accepted) + len(refused) == 32 and accepted
    assert fe._m_submitted.value == len(accepted)
    assert fe._m_rejected.value == len(refused)
    assert all(ts.inflight == 0 for ts in fe._tenants.values())
    assert eng.stats.requests == len(accepted)

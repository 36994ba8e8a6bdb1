"""The port's copy of the observability plane (``repro_torch.obs``) against
the JAX package's (``repro.obs``): the metrics, stats-view, trace and ledger
cases of ``tests/test_obs.py``, run on the port's copy, with the same
operations fed to both copies wherever the result is deterministic (P²
quantiles, registry snapshots and Prometheus text, ledger views), which must
then agree exactly. Then the port's weight cache and engine publishing into
the plane on the CPU."""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import repro.obs.ledger as jax_ledger
import repro.obs.metrics as jax_metrics
import repro.obs.stats as jax_stats
from repro.core.switching import SwitchStats as JaxSwitchStats
from repro.serving.engine import ServeStats as JaxServeStats
from repro.serving.kvcache import PagedStats as JaxPagedStats
from repro_torch.bridge import tree_bytes, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.core.switching import HBMWeightCache, SwitchStats
from repro_torch.models import get_model
from repro_torch.obs import trace
from repro_torch.obs.httpd import serve_metrics
from repro_torch.obs.ledger import TransferLedger
from repro_torch.obs.metrics import (Histogram, MetricsRegistry, get_registry,
                                     scoped)
from repro_torch.obs.stats import StatsView, as_dict, counter_field, gauge_field
from repro_torch.obs.trace import NOOP_SPAN, Tracer, validate_chrome_trace
from repro_torch.serving import PagedStats, Request, ServeStats, ServingEngine
from repro_torch.store import HostMemoryStore


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------
# streaming quantiles and the registry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_p2_quantiles_match_exact_and_jax(dist):
    rs = np.random.RandomState(0)
    xs = (rs.uniform(0.0, 10.0, 20000) if dist == "uniform"
          else rs.lognormal(0.0, 0.75, 20000))
    h, jh = Histogram("lat"), jax_metrics.Histogram("lat")
    for x in xs:
        h.observe(float(x))
        jh.observe(float(x))
    for p in (0.5, 0.95, 0.99):
        exact = float(np.percentile(xs, p * 100))
        assert h.quantile(p) == pytest.approx(exact, rel=0.05), f"p{p}"
    assert h.summary() == jh.summary()      # same arithmetic, same bits
    s = h.summary()
    assert s["count"] == len(xs)
    assert s["min"] == pytest.approx(xs.min())
    assert s["max"] == pytest.approx(xs.max())
    assert s["mean"] == pytest.approx(xs.mean(), rel=1e-6)
    # fewer than five samples: exact, from the sorted samples
    few = Histogram("lat")
    assert few.quantile(0.5) == 0.0
    for x in [3.0, 1.0, 2.0]:
        few.observe(x)
    assert few.quantile(0.5) == 2.0


def test_registry_snapshot_prometheus_and_http_match_jax():
    regs = (MetricsRegistry(), jax_metrics.MetricsRegistry())
    for reg in regs:
        c1 = reg.counter("x.hits")
        c1.inc(3)
        assert reg.counter("x.hits") is c1                 # get-or-create
        c2 = reg.counter("x.hits", {"group": "g0"})
        assert c2 is not c1                                # labels split
        c2.inc()
        reg.gauge("kv.blocks_in_use", {"group": "g0"}).set(7)
        reg.histogram("serve.ttft_s").observe(0.25)
        reg.derived_gauge("ledger.overlap_ratio", lambda: 0.5)
        with pytest.raises(TypeError):
            reg.gauge("x.hits")                            # kind mismatch
    port, jax_ = regs
    assert port.snapshot() == jax_.snapshot()
    assert port.to_prometheus() == jax_.to_prometheus()
    snap, text = port.snapshot(), port.to_prometheus()
    assert snap["x.hits"] == 3 and snap["x.hits{group=g0}"] == 1
    assert "# TYPE x_hits counter" in text
    assert 'x_hits{group="g0"} 1' in text
    # scoped() swaps the process default registry for the block only
    outer = get_registry()
    with scoped() as reg:
        assert get_registry() is reg
        reg.counter("only.inner").inc()
    assert get_registry() is outer
    assert "only.inner" not in outer.snapshot()
    # the same registry over HTTP on localhost
    srv = serve_metrics(port, port=0)
    try:
        text = urllib.request.urlopen(f"{srv.url}/metrics").read().decode()
        assert text == port.to_prometheus()
        assert "serve_ttft_s_count 1" in text
        snap = json.loads(
            urllib.request.urlopen(f"{srv.url}/metrics.json").read())
        assert snap == json.loads(json.dumps(port.snapshot()))
        assert snap["serve.ttft_s:count"] == 1
        assert urllib.request.urlopen(f"{srv.url}/healthz").status == 200
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# stats views
# ----------------------------------------------------------------------
class _ToyStats(StatsView):
    PREFIX = "toy"
    DERIVED = ("double",)

    hits = counter_field()
    lat_s = counter_field(0.0)
    depth = gauge_field()

    @property
    def double(self):
        return 2 * self.hits


def test_statsviews_are_registry_backed_with_jax_keys():
    reg = MetricsRegistry()
    st = _ToyStats(registry=reg, labels={"group": "g1"}, hits=2)
    st.hits += 3
    st.lat_s += 0.25
    st.depth = 7
    snap = reg.snapshot()
    assert snap["toy.hits{group=g1}"] == 5
    assert snap["toy.lat_s{group=g1}"] == 0.25
    assert snap["toy.depth{group=g1}"] == 7
    assert st.as_dict() == {"hits": 5, "lat_s": 0.25, "depth": 7,
                            "double": 10}
    st.reset()
    assert st.hits == 0 and reg.snapshot()["toy.hits{group=g1}"] == 0
    st.hits += 1                          # reset keeps the same series
    assert reg.snapshot()["toy.hits{group=g1}"] == 1
    a, b = _ToyStats(), _ToyStats()
    a.hits += 5
    assert b.hits == 0                    # a private registry per bare view
    # the port's three serving views: JAX's prefixes, fields and as_dict
    for port_cls, jax_cls in ((SwitchStats, JaxSwitchStats),
                              (PagedStats, JaxPagedStats),
                              (ServeStats, JaxServeStats)):
        assert port_cls.PREFIX == jax_cls.PREFIX
        assert port_cls._FIELDS == jax_cls._FIELDS
        assert port_cls().as_dict() == jax_cls().as_dict()
        assert port_cls().registry.snapshot() == \
            jax_cls().registry.snapshot()
    d = as_dict(HostMemoryStore().stats)  # plain dataclasses too
    assert d == jax_stats.as_dict(HostMemoryStore().stats)
    assert "reads" in d and "bytes_read" in d


# ----------------------------------------------------------------------
# transfer ledger
# ----------------------------------------------------------------------
def test_ledger_edges_stalls_and_overlap_like_jax():
    views = []
    for reg, led in ((r := MetricsRegistry(), TransferLedger(r)),
                     (j := jax_metrics.MetricsRegistry(),
                      jax_ledger.TransferLedger(j))):
        led.record("store_read", 1000, 0.4, cause="miss", expert="e0")
        led.record("h2d", 1000, 0.6, cause="miss")
        led.record("elided", 512, cause="read_only", expert="e1")
        led.note_stall(0.2, cause="miss")
        led.reserve(512)
        assert led.reserved_bytes == 512
        led.release(512)
        with pytest.raises(ValueError):
            led.record("sideways", 1, 0.1)
        views.append((led.as_dict(), reg.snapshot()))
    assert views[0] == views[1]
    d, snap = views[0]
    assert d["store_read_bytes"] == 1000 and d["hbm_reserved_bytes"] == 0
    assert d["stall_seconds"] == pytest.approx(0.2)
    assert d["overlap_ratio"] == pytest.approx(0.8)
    assert d["h2d_bandwidth_bps"] == pytest.approx(1000 / 0.6)
    assert snap["ledger.bytes{cause=miss,edge=store_read}"] == 1000
    assert snap["ledger.bytes_by_expert{expert=e0}"] == 1000
    assert snap["ledger.overlap_ratio"] == pytest.approx(0.8)


# ----------------------------------------------------------------------
# tracing
# ----------------------------------------------------------------------
def test_tracing_noop_nesting_threads_and_validator():
    tr = Tracer()
    assert tr.span("x") is NOOP_SPAN        # disabled: a shared singleton
    assert tr.span("y", request_id=1) is NOOP_SPAN
    with tr.span("x") as sp:
        assert sp.add(k=1) is sp
    tr.instant("i")
    tr.async_begin("r", id=1)
    tr.async_end("r", id=1)
    assert tr.events() == []

    tr.start()
    with tr.span("outer", cat="t"):
        time.sleep(0.002)
        with tr.span("inner", cat="t"):
            time.sleep(0.002)
        time.sleep(0.002)
    tr.stop()
    evs = {e["name"]: e for e in tr.events()}
    o, i = evs["outer"], evs["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1.0
    assert o["dur"] >= i["dur"]

    tr = Tracer()
    tr.start()
    n_threads, n_spans = 8, 200
    barrier = threading.Barrier(n_threads)

    def worker(k):
        barrier.wait()
        for j in range(n_spans):
            with tr.span("w", cat="t", thread=k, j=j):
                pass
            tr.instant("tick", cat="t", thread=k)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tr.stop()
    evs = tr.events()
    assert len(evs) == n_threads * n_spans * 2
    assert len({e["tid"] for e in evs}) == n_threads
    assert validate_chrome_trace(tr.to_chrome_trace()) == []

    assert validate_chrome_trace({}) == ["missing top-level 'traceEvents'"]
    bad = {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0},
        {"name": "q", "ph": "?", "pid": 1, "tid": 1, "ts": 0.0},
        {"name": "r", "ph": "e", "id": 9, "pid": 1, "tid": 1, "ts": 0.0},
        {"name": "r", "ph": "b", "id": 8, "pid": 1, "tid": 1, "ts": 0.0},
    ]}
    problems = validate_chrome_trace(bad)
    for want in ("without dur", "unknown phase", "end before begin",
                 "unclosed"):
        assert any(want in p for p in problems), want


# ----------------------------------------------------------------------
# the weight cache and the engine publishing into the plane
# ----------------------------------------------------------------------
class _FailOnceStore(HostMemoryStore):
    def __init__(self):
        super().__init__()
        self.fail_next = False

    def get(self, name):
        if self.fail_next:
            self.fail_next = False
            raise IOError("transient capacity-tier read failure")
        return super().get(name)


def test_cache_publishes_ledger_stalls_and_gauges():
    reg = MetricsRegistry()
    s = HostMemoryStore()
    s.put("e0", {"w": torch.zeros(4096)})
    s.put("e1", {"w": torch.ones(4096)})
    cache = HBMWeightCache(20000, store=s, device="cpu", registry=reg,
                           labels={"group": "g0"})
    cache.activate("e0")
    snap = reg.snapshot()
    assert snap["switch.misses{group=g0}"] == 1
    assert snap["switch.hbm_used_bytes{group=g0}"] == cache.used_bytes
    assert snap["ledger.bytes{cause=miss,edge=store_read,group=g0}"] == 16384
    assert cache.ledger.bytes_moved("h2d") == cache.stats.bytes_copied_in
    assert cache.prefetch("e1")            # evicts e0: room for one
    assert cache.ledger.reserved_bytes == 16384
    cache.activate("e1")                   # consumes the reservation
    assert cache.ledger.reserved_bytes == 0
    snap = reg.snapshot()
    assert snap["switch.prefetch_hits{group=g0}"] == 1
    assert snap["ledger.bytes{cause=read_only,edge=elided,group=g0}"] == 16384
    assert snap["ledger.bytes{cause=prefetch,edge=h2d,group=g0}"] == 16384
    st = cache.stats
    assert st.switch_seconds == pytest.approx(
        st.stall_miss_seconds + st.stall_prefetch_seconds, rel=1e-6)
    assert st.drops == 0 and st.bytes_copied_back == 0
    cache.close()

    # a failed prefetch: its wait is its own stall cause, not miss time
    s = _FailOnceStore()
    s.put("e0", {"w": torch.zeros(1024)})
    cache = HBMWeightCache(1 << 20, store=s, device="cpu")
    s.fail_next = True
    assert cache.prefetch("e0") is True
    cache.activate("e0")
    st = cache.stats
    assert st.prefetch_failures == 1 and st.misses == 1
    assert st.prefetch_hits == 0
    assert st.switch_seconds == pytest.approx(
        st.stall_miss_seconds + st.stall_failed_prefetch_seconds, rel=1e-6)
    snap = st.registry.snapshot()
    assert "ledger.stall_seconds{cause=failed_prefetch}" in snap
    assert snap["ledger.stall_seconds{cause=miss}"] > 0.0
    assert cache.ledger.reserved_bytes == 0
    cache.close()


def _mk_engine(n_experts=2, **kw):
    cfg = reduced(get_config("samba-coe-expert-7b"))
    m = get_model(cfg)
    trees = [tree_map(lambda t: t.float(),
                      m.init(torch.Generator().manual_seed(i), "cpu"))
             for i in range(n_experts)]
    nbytes = tree_bytes(trees[0])
    coe = CompositionOfExperts(HashRouter(n_experts), None,
                               int(2.5 * nbytes), device="cpu",
                               registry=kw.get("registry"))
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, t))
    return ServingEngine(coe, cfg, max_len=32, n_slots=2, block_size=8,
                         kv_dtype=torch.float32, device="cpu", **kw)


def _mk_requests(cfg, n, new_tokens=4):
    rs = np.random.RandomState(0)
    return [Request(rid=i, tokens=rs.randint(0, cfg.vocab_size,
                                             (8,)).astype(np.int32),
                    max_new_tokens=new_tokens) for i in range(n)]


@pytest.mark.parametrize("prefill_mode", ["packed", "sequential"])
def test_engine_trace_covers_request_lifecycle(prefill_mode, tmp_path):
    old = trace.set_tracer(Tracer())
    try:
        eng = _mk_engine(prefill_mode=prefill_mode,
                         registry=MetricsRegistry())
        reqs = _mk_requests(eng.cfg, 4)
        eng.submit(reqs[0])                # first launches outside the trace
        eng.drain()
        trace.enable()
        for r in reqs[1:]:
            eng.submit(r)
        t0 = time.perf_counter()
        done = eng.drain()
        wall = time.perf_counter() - t0
        trace.disable()
        assert len(done) == 3
        evs = trace.events()
        names = {e["name"] for e in evs}
        assert {"route", "step", "prefill", "decode", "admit",
                "request"} <= names
        begins = {e["id"] for e in evs
                  if e["ph"] == "b" and e["name"] == "request"}
        ends = {e["id"] for e in evs
                if e["ph"] == "e" and e["name"] == "request"}
        assert begins == ends == {r.rid for r in reqs[1:]}
        prefills = [e for e in evs if e["name"] == "prefill"]
        packed = {e["args"]["prefill.packed"] for e in prefills}
        assert (packed == {0}) == (prefill_mode == "sequential")
        step_s = sum(e["dur"] for e in evs
                     if e["name"] == "step" and e["ph"] == "X") / 1e6
        assert step_s == pytest.approx(wall, rel=0.10)
        path = trace.export(tmp_path / "trace.json")
        doc = json.loads(path.read_text())
        assert validate_chrome_trace(doc) == []
        assert any(e["ph"] == "M" for e in doc["traceEvents"])
    finally:
        trace.set_tracer(old)

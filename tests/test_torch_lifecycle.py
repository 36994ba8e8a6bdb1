"""The lifecycle half of the port's observability plane, from
``tests/test_lifecycle_plane.py``: the per-request phase ledger, SLO
attainment and goodput, the watchdog's fault injections, the flight
recorder, the metrics httpd on localhost port 0 and the SIGUSR2 dump, with
the port's engine (CPU, reduced expert) as the system under watch. Where a
function is pure (``phase_record``), the JAX package's copy is held to the
same answer."""
import json
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs.lifecycle import phase_record as jax_phase_record
from repro_torch.bridge import tree_bytes, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.models import get_model
from repro_torch.obs import flightrec, trace
from repro_torch.obs.flightrec import FlightRecorder, validate_bundle
from repro_torch.obs.httpd import serve_metrics
from repro_torch.obs.lifecycle import PHASES, phase_record
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import SLOTracker, request_slo_met
from repro_torch.obs.trace import Tracer, validate_chrome_trace
from repro_torch.obs.watchdog import Watchdog, WatchdogError
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def experts():
    cfg = reduced(get_config("samba-coe-expert-7b"))
    m = get_model(cfg)
    trees = [tree_map(lambda t: t.float(),
                      m.init(torch.Generator().manual_seed(i), "cpu"))
             for i in range(2)]
    return cfg, trees


def _mk_engine(experts, **kw):
    cfg, trees = experts
    coe = CompositionOfExperts(HashRouter(len(trees)), None,
                               int(2.5 * tree_bytes(trees[0])), device="cpu",
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


def _finished(rid, *, tenant="a", ttft=0.1, tpot=0.01, n_out=5,
              slo_ttft=None, slo_tpot=None):
    r = Request(rid=rid, tokens=np.zeros(4, np.int32), max_new_tokens=n_out,
                tenant=tenant, slo_ttft_s=slo_ttft, slo_tpot_s=slo_tpot)
    r.arrival_s = 0.0
    r.first_token_s = ttft
    r.done_s = ttft + tpot * (n_out - 1)
    r.output = np.arange(n_out, dtype=np.int32)
    return r


def test_phase_record_and_slo_hand_computed():
    r = Request(rid=7, tokens=np.zeros(4, np.int32), max_new_tokens=5,
                tenant="acme", priority=2)
    r.arrival_s, r.submit_s, r.admit_s = 10.0, 10.5, 11.0
    r.route_s = 0.1
    r.first_token_s, r.done_s = 11.4, 12.4
    r.output = np.arange(5, dtype=np.int32)
    rec = phase_record(r)
    assert rec == jax_phase_record(r)      # the port's Request, JAX's ledger
    ph = rec["phases"]
    for name, want in (("queue_wait", 0.5), ("route", 0.1),
                       ("admit_wait", 0.4), ("prefill", 0.4),
                       ("decode", 1.0)):
        assert ph[name] == pytest.approx(want), name
    assert rec["wall_s"] == pytest.approx(2.4)
    assert rec["ttft_s"] == pytest.approx(1.4)
    assert rec["tpot_s"] == pytest.approx(1.0 / 4)
    assert rec["tenant"] == "acme" and rec["priority"] == 2

    reg = MetricsRegistry()
    t = {"now": 100.0}
    tr = SLOTracker(reg, target_attainment=0.9, windows=(60.0,),
                    clock=lambda: t["now"])
    t["now"] = 105.0
    assert tr.observe(_finished(1, slo_ttft=1.0, slo_tpot=0.5))
    assert tr.observe(_finished(2, slo_ttft=1.0))
    assert not tr.observe(_finished(3, ttft=2.0, slo_ttft=1.0))
    assert tr.observe(_finished(4, tenant="b"))      # no SLO: met
    t["now"] = 110.0
    assert tr.attainment("a") == pytest.approx(2 / 3)
    assert tr.attainment() == pytest.approx(3 / 4)
    assert tr.goodput("a") == pytest.approx(10 / 10.0)
    assert tr.goodput("a", wall_s=5.0) == pytest.approx(2.0)
    assert tr.burn_rate(60.0, "a") == pytest.approx((1 / 3) / 0.1)
    assert tr.burn_rate(60.0, "b") == 0.0
    snap = reg.snapshot()
    assert snap["slo.requests{priority=0,tenant=a}"] == 3
    assert snap["slo.requests_met{priority=0,tenant=a}"] == 2
    assert snap["slo.ttft_miss{priority=0,tenant=a}"] == 1
    assert snap["slo.tokens_met{priority=0,tenant=a}"] == 10
    assert tr.as_dict("a")["tokens_out"] == 15
    assert tr.tenants() == ["a", "b"]
    assert request_slo_met(_finished(1))
    assert request_slo_met(_finished(2, slo_ttft=1.0, slo_tpot=0.5))
    assert not request_slo_met(_finished(3, ttft=2.0, slo_ttft=1.0))
    assert not request_slo_met(_finished(4, tpot=1.0, slo_tpot=0.5))


@pytest.mark.parametrize("prefill_mode", ["packed", "sequential"])
def test_engine_drain_phases_telescope_and_feed_slo(experts, prefill_mode):
    reg = MetricsRegistry()
    eng = _mk_engine(experts, registry=reg, prefill_mode=prefill_mode)
    streamed, finished = {}, []
    reqs = _mk_requests(experts[0], 5)
    for r in reqs:
        r.slo_ttft_s, r.slo_tpot_s = 60.0, 60.0
        r.on_token = lambda q, tok: streamed.setdefault(q.rid, []).append(tok)
        r.on_done = finished.append
        eng.submit(r)
    done = eng.drain()
    assert len(done) == 5 and finished == done
    for r in done:                          # every token streamed, in order
        assert streamed[r.rid] == list(r.output)
    recs = eng.lifecycle.records()
    assert len(recs) == 5
    for rec in recs:
        total = sum(rec["phases"][p] for p in PHASES)
        assert total == pytest.approx(rec["wall_s"], abs=1e-9)
        for p in PHASES:
            assert rec["phases"][p] >= -1e-9, (p, rec["phases"][p])
    snap = reg.snapshot()
    assert snap["serve.phase_seconds:count{phase=decode}"] == 5
    assert snap["serve.phase_seconds:count{phase=queue_wait}"] == 5
    assert snap["serve.tpot_s:count"] == 5
    assert snap["serve.ttft_s:count"] == 5
    assert eng.slo.attainment() == 1.0 and eng.slo.goodput() > 0.0
    assert snap["slo.requests_met{priority=0,tenant=default}"] == 5
    bucket = sum(v for k, v in snap.items()
                 if k.startswith("serve.prefill_bucket"))
    assert bucket == 5


def test_watchdog_clean_drain_and_injected_faults(experts, tmp_path):
    reg = MetricsRegistry()
    rec = FlightRecorder()
    eng = _mk_engine(experts, registry=reg)
    for r in _mk_requests(experts[0], 3):
        eng.submit(r)
    eng.drain()
    wd = Watchdog([eng], strict=True, stall_s=30.0, queue_age_s=60.0,
                  recorder=rec, dump_path=tmp_path / "dump.json")
    assert wd.check_now() == []
    assert "obs.anomaly{kind=stuck_request}" not in reg.snapshot()

    # a request that stops making progress
    req = _mk_requests(experts[0], 1, new_tokens=8)[0]
    req.rid = 100
    eng.submit(req)
    eng.step()
    occupied = [i for i, s in enumerate(eng.slots) if s is not None]
    assert occupied
    req.last_token_s -= 100.0
    with pytest.raises(WatchdogError) as ei:
        wd.check_now()
    stuck = next(a for a in ei.value.anomalies
                 if a["kind"] == "stuck_request")
    assert stuck["slot"] == occupied[0] and stuck["rid"] == req.rid
    assert reg.snapshot()["obs.anomaly{kind=stuck_request}"] == 1
    doc = json.loads((tmp_path / "dump.json").read_text())
    assert validate_bundle(doc) == []
    assert doc["reason"] == "watchdog_anomaly"
    assert any(e.get("slot") == occupied[0] and e.get("rid") == req.rid
               for e in doc["events"] if e["kind"] == "anomaly")
    req.last_token_s += 100.0
    eng.drain()
    assert wd.check_now() == []

    # a KV block that vanishes from the books
    leaked = eng.pool._free.pop()
    with pytest.raises(WatchdogError) as ei:
        wd.check_now()
    assert {a["kind"] for a in ei.value.anomalies} == {"kv_invariant"}
    assert "partition" in ei.value.anomalies[0]["violations"][0]
    eng.pool._free.append(leaked)
    assert wd.check_now() == []

    # a request that waits in the queue too long
    req = _mk_requests(experts[0], 1)[0]
    req.rid = 200
    eng.submit(req)
    req.submit_s -= 100.0
    req.arrival_s -= 100.0
    lax = Watchdog([eng], strict=False, queue_age_s=60.0, recorder=rec)
    assert "queue_stall" in {a["kind"] for a in lax.check_now()}
    eng.drain()
    assert eng.hbm_in_budget() and eng.pool.stats.blocks_in_use == 0

    # the background sampler
    bg = Watchdog([eng], interval_s=0.01, recorder=rec).start()
    time.sleep(0.1)
    bg.stop()
    assert bg.checks_run >= 2


def test_flightrec_ring_bundle_and_validator(tmp_path):
    rec = FlightRecorder(capacity=4)
    for i in range(10):
        rec.record("admit", rid=i)
    evs = rec.events()
    assert len(evs) == 4 and rec.dropped_events == 6
    assert [e["rid"] for e in evs] == [6, 7, 8, 9]

    reg = MetricsRegistry()
    reg.counter("x.hits").inc(3)
    rec = FlightRecorder(capacity=16)
    rec.record("switch", expert="e1", stall_s=0.5)
    rec.add_state_provider("slots", lambda: {"free": 2})
    rec.add_state_provider("broken", lambda: 1 / 0)
    doc = json.loads(rec.dump(tmp_path / "flight.json", reg,
                              reason="test").read_text())
    assert validate_bundle(doc) == []
    assert doc["reason"] == "test" and doc["metrics"]["x.hits"] == 3
    assert doc["state"]["slots"] == {"free": 2}
    assert "ZeroDivisionError" in doc["state"]["broken"]["error"]
    assert doc["events"][0]["kind"] == "switch"

    assert validate_bundle([]) == ["bundle is not an object"]
    problems = validate_bundle({"schema": "wrong", "events": [{"x": 1}]})
    for want in ("schema", "missing kind/ts", "metrics"):
        assert any(want in p for p in problems), want


def test_engine_flight_events_and_trace_ring_drops(experts):
    old = flightrec.set_recorder(FlightRecorder())
    try:
        eng = _mk_engine(experts, registry=MetricsRegistry())
        for r in _mk_requests(experts[0], 3):
            eng.submit(r)
        done = eng.drain()
        evs = flightrec.get_recorder().events()
        assert {"admit", "done", "switch"} <= {e["kind"] for e in evs}
        assert {e["rid"] for e in evs if e["kind"] == "done"} == \
            {r.rid for r in done}
    finally:
        flightrec.set_recorder(old)

    old = trace.set_tracer(Tracer(buffer_size=4))
    try:
        reg = MetricsRegistry()
        trace.register_metrics(reg)
        trace.enable()
        for i in range(10):
            trace.instant("tick", i=i)
        trace.disable()
        assert trace.dropped_events() == 6 and len(trace.events()) == 4
        doc = trace.get_tracer().to_chrome_trace()
        assert doc["metadata"]["trace.dropped_events"] == 6
        assert reg.snapshot()["trace.dropped_events"] == 6
        trace.get_tracer().clear()
        assert trace.dropped_events() == 0
    finally:
        trace.set_tracer(old)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read()


def test_httpd_readyz_and_engine_debug_endpoints(experts):
    reg = MetricsRegistry()
    rec = FlightRecorder()
    rec.record("admit", rid=1)
    eng = _mk_engine(experts, registry=reg)
    srv = serve_metrics(reg, port=0, ready_check=lambda: eng.warmed,
                        debug=eng.debug_providers(), recorder=rec)
    try:
        base = srv.url
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/readyz")
        assert ei.value.code == 503                    # not warmed yet
        assert _get(f"{base}/healthz")[0] == 200
        eng.warmup()
        assert eng.warmed and eng.pool.stats.blocks_in_use == 0
        assert eng.pool.check_invariants() == []
        status, body = _get(f"{base}/readyz")
        assert status == 200 and body == b"ready\n"
        for r in _mk_requests(experts[0], 2):
            eng.submit(r)
        eng.drain()
        slots = json.loads(_get(f"{base}/debug/slots")[1])
        assert len(slots["slots"]) == eng.n_slots
        assert all(s["state"] == "free" for s in slots["slots"])
        pool = json.loads(_get(f"{base}/debug/pool")[1])
        assert pool["invariant_violations"] == []
        assert pool["blocks_in_use"] == 0 and pool["open_rids"] == []
        assert pool["reclaimable_blocks"] == 0
        assert json.loads(_get(f"{base}/debug/sessions")[1]) == \
            {"sessions": [], "bytes_retained": 0}
        doc = json.loads(_get(f"{base}/debug/flight")[1])
        assert validate_bundle(doc) == []
        assert doc["events"][0]["rid"] == 1
        idx = json.loads(_get(f"{base}/")[1])
        assert {"/readyz", "/debug/slots", "/debug/pool"} <= \
            set(idx["endpoints"])
        text = _get(f"{base}/metrics")[1].decode()
        for series in ("serve_ttft_s_count", "kv_blocks_in_use",
                       "switch_hits", 'serve_backend{backend="fused"}'):
            assert series in text, series
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/debug/nope")
        assert ei.value.code == 404
        srv.add_debug("boom", lambda: 1 / 0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/debug/boom")
        assert ei.value.code == 500
    finally:
        srv.stop()


def test_sigusr2_dumps_flight_bundle(experts, tmp_path):
    from repro_torch.launch.serve import install_flight_dump_signal

    old_rec = flightrec.set_recorder(FlightRecorder())
    prev = signal.getsignal(signal.SIGUSR2)
    try:
        reg = MetricsRegistry()
        eng = _mk_engine(experts, registry=reg)
        req = _mk_requests(experts[0], 1, new_tokens=8)[0]
        eng.submit(req)
        eng.step()                          # a live, seated slot
        for name, fn in eng.debug_providers().items():
            flightrec.add_state_provider(name, fn)
        out = tmp_path / "sig.json"
        assert install_flight_dump_signal(out, registry=reg) \
            == signal.SIGUSR2
        signal.raise_signal(signal.SIGUSR2)
        doc = json.loads(out.read_text())
        assert validate_bundle(doc) == [] and doc["reason"] == "signal"
        busy = [s for s in doc["state"]["slots"]["slots"]
                if s["state"] == "decoding"]
        assert busy and busy[0]["rid"] == req.rid
        assert doc["state"]["pool"]["blocks_in_use"] > 0
        eng.drain()
    finally:
        signal.signal(signal.SIGUSR2, prev)
        flightrec.set_recorder(old_rec)


def test_serve_driver_wires_the_plane(tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` with every plane flag: the
    run-to-completion scheduler, sequential prefill, warmup, the metrics
    server, the watchdog and a trace export."""
    from repro_torch.launch.serve import main
    from repro_torch.obs.metrics import scoped

    old = trace.set_tracer(Tracer())
    prev = signal.getsignal(signal.SIGUSR2)
    try:
        with scoped():
            engine, done = main([
                "--device", "cpu", "--reduced", "--requests", "4",
                "--prompt-len", "6", "12", "--new-tokens", "3",
                "--max-len", "32", "--n-slots", "2",
                "--scheduler", "run_to_completion",
                "--prefill-mode", "sequential", "--warmup",
                "--metrics-port", "0", "--watchdog",
                "--watchdog-interval", "0.01",
                "--trace-out", str(tmp_path / "t.json"),
                "--flight-out", str(tmp_path / "f.json")])
    finally:
        signal.signal(signal.SIGUSR2, prev)
        trace.set_tracer(old)
    out = capsys.readouterr().out
    assert "leaked=0" in out and "metrics: http://127.0.0.1:" in out
    assert len(done) == 4 and engine.warmed
    assert engine.scheduler == "run_to_completion"
    assert engine.prefill_runner is None
    doc = json.loads((tmp_path / "t.json").read_text())
    assert validate_chrome_trace(doc) == []
    lanes = {e["id"] for e in doc["traceEvents"]
             if e.get("ph") == "b" and e["name"] == "request"}
    assert lanes == {r.rid for r in done}
    assert not (tmp_path / "f.json").exists()      # no anomaly, no dump

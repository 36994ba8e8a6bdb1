"""The engine's tenancy (``prefix_sharing=True``: the prefix index, session
retention and suffix prefill through the g > 1 paged extend) against the
JAX package's engine, on the CPU. A multi-turn session trace (the shape of
``tests/test_kv_sharing.py``'s ``_session_trace`` / ``_replay``: four
sessions on two experts sharing one system prompt, two turns, each turn
re-sending the conversation so far) runs through both packages' engines
(the port's reference backend, JAX's XLA backend; the same f32 experts
through ``bridge``; f32 KV) in both admission modes. The token streams must
be identical, ``prefix_hit_tokens`` and ``cow_splits`` equal, and the
registries must hold the same series with the same value in every integer
counter and gauge (the comparison of ``test_torch_engine_modes.py``).
Inside the port, the shared and unshared streams must be identical, the
second turn must adopt its history, and ``release_shared()`` must leave no
block in use."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import CompositionOfExperts as JaxCoE
from repro.core import ExpertHandle as JaxHandle
from repro.core import HashRouter as JaxHashRouter
from repro.models import get_model as jax_get_model
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import Request, ServingEngine, XlaPagedBackend

ENGINE = dict(max_len=64, block_size=8)
TENANCY = ("serve.prefix_hit_tokens", "kv.shared_blocks", "kv.cow_splits")


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
    trees = [jax.tree.map(lambda x: np.asarray(x, np.float32),
                          m.init(jax.random.fold_in(rng, i)))
             for i in range(2)]
    nbytes = sum(x.nbytes for x in jax.tree.leaves(trees[0]))
    return jcfg, reduced(get_config("samba-coe-expert-7b")), trees, nbytes


def _session_trace(vocab, n_sessions=4, turns=2):
    rs = np.random.RandomState(11)
    sysp = rs.randint(1, vocab, (12,)).astype(np.int32)
    trace = [{"sid": f"s{s}", "expert": f"e{s % 2}", "sys": sysp,
              "user": [rs.randint(1, vocab, (5,)).astype(np.int32)
                       for _ in range(turns)]}
             for s in range(n_sessions)]
    return trace, turns


def _replay(eng, cls, trace, turns, sharing, on_step=None):
    """Submit each turn of every session, drain, grow each history by the
    turn's output. Returns {rid: output} and {rid: finished request}."""
    history, outs, reqs = {}, {}, {}
    for w in range(turns):
        rids = []
        for s in trace:
            p = np.concatenate([history.get(s["sid"], s["sys"]),
                                s["user"][w]])
            rid = w * 100 + int(s["sid"][1:])
            eng.submit(cls(rid=rid, tokens=p, max_new_tokens=3,
                           expert=s["expert"],
                           session_id=s["sid"] if sharing else None))
            rids.append((s, rid, p))
        done = {}
        while eng.has_work:
            for r in eng.step():
                done[r.rid] = r
            if on_step is not None:
                on_step(eng)
        for s, rid, p in rids:
            outs[rid] = done[rid].output
            reqs[rid] = done[rid]
            history[s["sid"]] = np.concatenate(
                [p, done[rid].output]).astype(np.int32)
    return outs, reqs


def _jax_engine(experts, prefill_mode, sharing, n_slots=2, **kw):
    jcfg, _, trees, nbytes = experts
    reg = JaxRegistry()
    coe = JaxCoE(JaxHashRouter(2), None, int(2.5 * nbytes), registry=reg)
    for i, t in enumerate(trees):
        coe.register(JaxHandle(f"e{i}", jcfg, t))
    eng = JaxEngine(coe, jcfg, backend="xla", kv_dtype=jnp.float32,
                    prefill_mode=prefill_mode, prefix_sharing=sharing,
                    registry=reg, n_slots=n_slots, **ENGINE, **kw)
    return eng, coe, reg


def _port_engine(experts, prefill_mode, sharing, session_max_bytes=None,
                 n_slots=2, **kw):
    _, cfg, trees, nbytes = experts
    reg = MetricsRegistry()
    coe = CompositionOfExperts(HashRouter(2), None, int(2.5 * nbytes),
                               device="cpu", registry=reg, **kw)
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    eng = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                        kv_dtype=torch.float32, device="cpu",
                        prefill_mode=prefill_mode, prefix_sharing=sharing,
                        session_max_bytes=session_max_bytes, registry=reg,
                        n_slots=n_slots, **ENGINE)
    return eng, coe, reg


def _series(reg):
    out = {}
    for m in reg.metrics():
        key = (m.name, m.kind, tuple(k for k, _ in m.labels))
        out.setdefault(key, set()).add(tuple(v for _, v in m.labels))
    return out


def _integer_series(reg):
    out = {}
    for m in reg.metrics():
        if m.kind == "histogram":
            out[(m.name + ":count", m.labels)] = m.count
        elif isinstance(m.value, int):
            out[(m.name, m.labels)] = m.value
    return out


@pytest.mark.parametrize("prefill_mode", ["packed", "sequential"])
def test_tenancy_drain_matches_jax_engine(experts, prefill_mode):
    _, cfg, _, _ = experts
    trace, turns = _session_trace(cfg.vocab_size)
    jeng, jcoe, jreg = _jax_engine(experts, prefill_mode, True)
    want, _ = _replay(jeng, JaxRequest, trace, turns, True)
    eng, coe, reg = _port_engine(experts, prefill_mode, True)
    got, _ = _replay(eng, Request, trace, turns, True)
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
    assert eng.stats.prefix_hit_tokens == jeng.stats.prefix_hit_tokens > 0
    assert eng.pool.stats.cow_splits == jeng.pool.stats.cow_splits
    assert eng.debug_sessions() == jeng.debug_sessions()
    assert eng.debug_pool() == jeng.debug_pool()
    # the same series (names, label keys and values), every integer equal
    assert _series(reg) == _series(jreg)
    ji, pi = _integer_series(jreg), _integer_series(reg)
    assert set(pi) == set(ji)
    assert {k: pi[k] for k in ji} == ji
    for name in TENANCY:
        assert any(n == name for n, _ in ji), name
    for e in (eng, jeng):
        e.release_shared()
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.check_invariants() == []
    assert _integer_series(reg) == _integer_series(jreg)
    coe.cache.close()
    jcoe.cache.close()


def test_shared_equals_unshared_and_sessions_adopt(experts):
    """Inside the port: sharing changes where the KV lives, never the
    tokens, in both admission modes; each session's second turn adopts at
    least its whole first turn but the last token (whose KV was never
    written); with a carved KV budget every step stays inside the HBM
    budget; nothing leaks."""
    _, cfg, _, nbytes = experts
    trace, turns = _session_trace(cfg.vocab_size)
    for mode in ("packed", "sequential"):
        outs = {}
        for sharing in (False, True):
            eng, coe, _ = _port_engine(experts, mode, sharing)
            outs[sharing], reqs = _replay(eng, Request, trace, turns,
                                          sharing)
            if sharing:
                assert eng.stats.prefix_hit_tokens > 0
                for s in trace:
                    r1 = reqs[int(s["sid"][1:])]
                    r2 = reqs[100 + int(s["sid"][1:])]
                    assert r2.prefix_hit_tokens >= \
                        len(r1.tokens) + len(r1.output) - 1, s["sid"]
                eng.release_shared()
            assert eng.pool.stats.blocks_in_use == 0
            assert eng.pool.check_invariants() == []
            coe.cache.close()
        assert outs[False].keys() == outs[True].keys()
        for rid in outs[False]:
            np.testing.assert_array_equal(outs[True][rid], outs[False][rid],
                                          err_msg=f"{mode} rid {rid}")

    def in_budget(e):
        assert e.hbm_in_budget(), "HBM budget violated mid-drain"
        assert e.pool.check_invariants() == []

    eng, coe, _ = _port_engine(experts, "packed", True,
                               kv_reserve_bytes=int(0.5 * nbytes))
    budgeted, _ = _replay(eng, Request, trace, turns, True, in_budget)
    for rid in budgeted:
        np.testing.assert_array_equal(budgeted[rid], outs[False][rid])
    eng.release_shared()
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.stats.allocs == eng.pool.stats.frees
    coe.cache.close()


def test_warmup_runs_each_suffix_bucket_and_touches_only_scratch(experts):
    """``warmup()`` under sharing runs one all-inactive extend at every
    suffix bucket's width: the pool's real rows stay zero, nothing is
    allocated, and the engine then serves a prefix hit."""
    _, cfg, _, _ = experts
    eng, coe, _ = _port_engine(experts, "packed", True)
    widths = []
    real = eng.runner.extend

    def spy(params, pk, pv, tables, lengths, active, tokens):
        widths.append(int(tokens.shape[1]))
        return real(params, pk, pv, tables, lengths, active, tokens)

    eng.runner.extend = spy
    eng.warmup()
    assert eng.warmed
    assert widths == [1] + list(eng._suffix_buckets)
    scratch = eng.pool.scratch_index
    assert not eng.pool.k[:, :scratch].any()
    assert eng.pool.stats.allocs == 0
    trace, _ = _session_trace(cfg.vocab_size, n_sessions=1)
    s = trace[0]
    for rid in (0, 1):                      # the second hits the index
        eng.submit(Request(rid=rid, tokens=np.concatenate(
            [s["sys"], s["sys"], s["user"][0]]), max_new_tokens=2,
            expert="e0"))
        eng.drain()
    assert eng.stats.prefix_hit_tokens > 0
    assert max(widths[len(eng._suffix_buckets) + 1:]) > 1
    eng.release_shared()
    assert eng.pool.stats.blocks_in_use == 0
    coe.cache.close()


def test_session_cap_and_cow_split_as_jax_does(experts):
    """One slot, so a session's first turn meets the index a same-expert
    session filled: it adopts the system prompt's full block and part of
    the next (a copy-on-write split on its first write). A session byte cap
    of three blocks: retention evicts (``session_cap``) in both packages
    alike and the ledger records the same write-back and elided bytes. The
    streams equal JAX's and the unshared engine's."""
    _, cfg, _, _ = experts
    trace, turns = _session_trace(cfg.vocab_size, n_sessions=4, turns=3)
    eng, coe, reg = _port_engine(experts, "packed", False, n_slots=1)
    unshared, _ = _replay(eng, Request, trace, turns, False)
    coe.cache.close()
    cap = 3 * eng.pool._per_block_bytes()
    jeng, jcoe, _ = _jax_engine(experts, "packed", True, n_slots=1,
                                session_max_bytes=cap)
    want, _ = _replay(jeng, JaxRequest, trace, turns, True)
    eng, coe, reg = _port_engine(experts, "packed", True, n_slots=1,
                                 session_max_bytes=cap)
    got, _ = _replay(eng, Request, trace, turns, True)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
        np.testing.assert_array_equal(got[rid], unshared[rid],
                                      err_msg=str(rid))
    assert eng.sessions.max_bytes == cap
    assert eng.sessions.evictions == jeng.sessions.evictions > 0
    assert eng.debug_sessions() == jeng.debug_sessions()
    for edge in ("writeback", "elided"):
        assert coe.cache.ledger.bytes_moved(edge) == \
            jcoe.cache.ledger.bytes_moved(edge)
    assert eng.stats.prefix_hit_tokens == jeng.stats.prefix_hit_tokens
    assert eng.pool.stats.cow_splits == jeng.pool.stats.cow_splits > 0
    eng.release_shared()
    assert eng.pool.stats.blocks_in_use == 0
    coe.cache.close()
    jcoe.cache.close()

"""The engine's modes against the JAX package's engine: both schedulers
(``continuous``, ``run_to_completion``) under both prefill modes (``packed``,
``sequential``). The port's engine (reference backend, CPU) and JAX's (XLA
backend), on the same f32 experts through ``bridge`` and the same requests,
each publishing its engine, pool and weight cache into one registry. After
the drain the greedy streams must be identical, the registries must hold the
same metric names with the same label keys and the same value in every
integer counter and gauge (and every histogram's count), and every
request's five lifecycle phases must telescope to its wall time."""
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
from repro_torch.obs.lifecycle import PHASES
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import Request, ServingEngine, XlaPagedBackend

ENGINE = dict(max_len=48, n_slots=3, block_size=8)
# expert of each request: strictly decreasing demand (4 / 3 / 2) keeps the
# continuous scheduler's queue pick independent of when a JAX background
# prefetch lands
EXPERT_OF = [0, 1, 0, 2, 1, 0, 1, 2, 0]
# the integer series the issue names, at least; every other integer series
# is compared too
NAMED = ("serve.requests", "serve.admitted", "serve.tokens_out",
         "switch.hits", "switch.misses", "kv.allocs", "kv.frees",
         "kv.blocks_in_use", "kv.peak_blocks")


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
             for i in range(3)]
    nbytes = sum(x.nbytes for x in jax.tree.leaves(trees[0]))
    return jcfg, reduced(get_config("samba-coe-expert-7b")), trees, nbytes


def _requests(cls, vocab):
    rs = np.random.RandomState(7)
    out = []
    for i, e in enumerate(EXPERT_OF):
        toks = rs.randint(0, vocab, (4 + 3 * (i % 4),)).astype(np.int32)
        out.append(cls(rid=i, tokens=toks, max_new_tokens=3 + i % 4,
                       expert=f"e{e}"))
    return out


def _jax_drain(experts, scheduler, prefill_mode):
    jcfg, _, trees, nbytes = experts
    reg = JaxRegistry()
    coe = JaxCoE(JaxHashRouter(3), None, int(2 * nbytes), registry=reg)
    for i, t in enumerate(trees):
        coe.register(JaxHandle(f"e{i}", jcfg, t))
    eng = JaxEngine(coe, jcfg, backend="xla", kv_dtype=jnp.float32,
                    scheduler=scheduler, prefill_mode=prefill_mode,
                    registry=reg, **ENGINE)
    for r in _requests(JaxRequest, jcfg.vocab_size):
        eng.submit(r)
    done = eng.drain()
    coe.cache.close()
    return done, eng, reg


def _port_drain(experts, scheduler, prefill_mode):
    _, cfg, trees, nbytes = experts
    reg = MetricsRegistry()
    coe = CompositionOfExperts(HashRouter(3), None, int(2 * nbytes),
                               device="cpu", registry=reg)
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    eng = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                        kv_dtype=torch.float32, device="cpu",
                        scheduler=scheduler, prefill_mode=prefill_mode,
                        registry=reg, **ENGINE)
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    done = eng.drain()
    coe.cache.close()
    return done, eng, reg


def _series(reg):
    """{(name, kind, label keys): set of label values} of a registry."""
    out = {}
    for m in reg.metrics():
        key = (m.name, m.kind, tuple(k for k, _ in m.labels))
        out.setdefault(key, set()).add(tuple(v for _, v in m.labels))
    return out


def _integer_series(reg):
    """Every integer-valued counter and gauge, and every histogram's
    count, by (name, labels)."""
    out = {}
    for m in reg.metrics():
        if m.kind == "histogram":
            out[(m.name + ":count", m.labels)] = m.count
        elif isinstance(m.value, int):
            out[(m.name, m.labels)] = m.value
    return out


@pytest.mark.parametrize("prefill_mode", ["packed", "sequential"])
@pytest.mark.parametrize("scheduler", ["continuous", "run_to_completion"])
def test_modes_match_jax_engine(experts, scheduler, prefill_mode):
    jdone, _, jreg = _jax_drain(experts, scheduler, prefill_mode)
    done, eng, reg = _port_drain(experts, scheduler, prefill_mode)

    # identical greedy streams
    want = {r.rid: r.output for r in jdone}
    got = {r.rid: r.output for r in done}
    assert got.keys() == want.keys() == set(range(len(EXPERT_OF)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))

    # the same series: names and label keys (and label values)
    assert _series(reg) == _series(jreg)
    # every integer counter and gauge, and every histogram's count, equal
    ji, pi = _integer_series(jreg), _integer_series(reg)
    assert set(pi) == set(ji)
    assert {k: pi[k] for k in ji} == ji
    for name in NAMED:
        assert any(n == name for n, _ in ji), name
    assert eng.stats.requests == len(EXPERT_OF)
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.check_invariants() == []
    assert eng.hbm_in_budget()

    # every request's phases telescope to its wall time
    recs = eng.lifecycle.records()
    assert len(recs) == len(EXPERT_OF)
    for rec in recs:
        total = sum(rec["phases"][p] for p in PHASES)
        assert total == pytest.approx(rec["wall_s"], abs=1e-9)
        assert min(rec["phases"].values()) >= -1e-9


def test_run_to_completion_serves_one_group_at_a_time(experts):
    """The baseline scheduler never refills a running batch: each expert's
    admitted requests decode to the end before the next group is seated."""
    _, cfg, trees, nbytes = experts
    coe = CompositionOfExperts(HashRouter(3), None, int(2 * nbytes),
                               device="cpu")
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    eng = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                        kv_dtype=torch.float32, device="cpu",
                        scheduler="run_to_completion",
                        prefill_mode="sequential", **ENGINE)
    with pytest.raises(ValueError, match="scheduler"):
        ServingEngine(coe, cfg, device="cpu", scheduler="fifo")
    with pytest.raises(ValueError, match="prefill_mode"):
        ServingEngine(coe, cfg, device="cpu", prefill_mode="chunked")
    assert not eng.warmed
    eng.warmup()
    assert eng.warmed and eng.pool.stats.blocks_in_use == 0
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    while eng.has_work:
        seated = {s.expert for s in eng.slots if s is not None}
        before = {s.req.rid for s in eng.slots if s is not None}
        eng.step()
        after = {s.req.rid for s in eng.slots if s is not None}
        assert len(seated) <= 1
        if before:
            assert after <= before            # no refill mid-batch
    coe.cache.close()

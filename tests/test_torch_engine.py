"""The slice as a whole: the port's ServingEngine (CPU, fused backend — the
kernels' plain versions) against the JAX package's ServingEngine (XLA
reference backend, f32 KV) on the same f32 experts and requests. The greedy
token streams must be identical, with equal switch counts and no leaked KV
blocks. Also the device rule, the router and the weight cache."""
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
from repro.core import plan_hbm_budget as jax_plan_hbm_budget
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.core import (DGX_H100, CompositionOfExperts, ExpertHandle,
                              HashRouter, model_switch_time, plan_hbm_budget)
from repro_torch.serving import Request, ServingEngine, XlaPagedBackend

ENGINE = dict(max_len=48, n_slots=4, block_size=8)
# expert of each request: strictly decreasing demand (4 / 3 / 2) keeps the
# queue-pick order independent of when a JAX background prefetch lands
EXPERT_OF = [0, 1, 0, 2, 1, 0, 1, 2, 0]


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


def _jax_drain(experts):
    jcfg, _, trees, nbytes = experts
    coe = JaxCoE(JaxHashRouter(3), None, int(2 * nbytes))
    for i, t in enumerate(trees):
        coe.register(JaxHandle(f"e{i}", jcfg, t))
    eng = JaxEngine(coe, jcfg, backend="xla", kv_dtype=jnp.float32, **ENGINE)
    for r in _requests(JaxRequest, jcfg.vocab_size):
        eng.submit(r)
    done = eng.drain()
    coe.cache.close()
    return {r.rid: r.output for r in done}, eng


def _port_drain(experts, backend):
    _, cfg, trees, nbytes = experts
    coe = CompositionOfExperts(HashRouter(3), None, int(2 * nbytes),
                               device="cpu")
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    be = XlaPagedBackend(cfg) if backend == "xla" else None
    eng = ServingEngine(coe, cfg, backend=be, kv_dtype=torch.float32,
                        device="cpu", **ENGINE)
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    done = eng.drain()
    return {r.rid: r.output for r in done}, eng


@pytest.fixture(scope="module")
def jax_result(experts):
    return _jax_drain(experts)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_greedy_streams_identical_to_jax_engine(experts, jax_result, backend):
    want, jeng = jax_result
    got, eng = _port_drain(experts, backend)
    assert got.keys() == want.keys() == set(range(len(EXPERT_OF)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
    assert eng.stats.switches == jeng.stats.switches >= 2
    assert eng.stats.tokens_out == jeng.stats.tokens_out
    assert eng.stats.decode_rounds == jeng.stats.decode_rounds
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.check_invariants() == []
    assert eng.coe.cache.stats.evictions >= 1      # 3 experts, room for 2
    assert set(eng.stats.as_dict()) == set(jeng.stats.as_dict())


def test_engine_default_device_is_the_card(experts):
    _, cfg, trees, nbytes = experts
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompositionOfExperts(HashRouter(3), None, int(2 * nbytes))
    coe = CompositionOfExperts(HashRouter(3), None, int(2 * nbytes),
                               device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(coe, cfg, **ENGINE)


def test_hash_router_is_bit_identical_to_jax():
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 32000, (64, 37)).astype(np.int32)
    for n, seed in ((3, 0), (150, 4)):
        np.testing.assert_array_equal(
            HashRouter(n, seed).route(None, toks),
            np.asarray(JaxHashRouter(n, seed).route(None, toks)))


def test_routed_requests_land_on_jax_experts(experts):
    _, cfg, trees, nbytes = experts
    coe = CompositionOfExperts(HashRouter(3), None, int(2 * nbytes),
                               device="cpu")
    jcoe = JaxCoE(JaxHashRouter(3), None, int(2 * nbytes))
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
        jcoe.register(JaxHandle(f"e{i}", experts[0], t))
    rs = np.random.RandomState(1)
    for _ in range(10):
        toks = rs.randint(0, 512, (9,)).astype(np.int32)
        assert coe.route_request(toks)[0] == jcoe.route_request(toks)[0]
    assert coe.memory_contract("e0")["hbm_bytes"] == nbytes


def test_weight_cache_lru_and_prefetch_on_cpu(experts):
    _, cfg, trees, nbytes = experts
    coe = CompositionOfExperts(HashRouter(3), None, int(2 * nbytes),
                               device="cpu")
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    c = coe.cache
    c.activate("e0")
    c.activate("e1")
    assert c.resident("e0") and c.resident("e1")
    assert c.prefetch("e2")                     # evicts LRU e0 for room
    assert c.ready("e2") and not c.resident("e0")
    assert c.used_bytes + c._reserved["e2"] <= c.capacity
    c.activate("e2")
    assert c.stats.prefetch_hits == 1 and c.stats.evictions == 1
    assert c.used_bytes <= c.capacity
    assert not c.prefetch("e2")                 # already resident
    assert model_switch_time(64e9) == 1.0 == model_switch_time(64e9, DGX_H100)


def test_plan_hbm_budget_matches_jax():
    for args in ((80e9, 13.5e9, 8e6), (30e9, 13.5e9, 8e6)):
        a = plan_hbm_budget(int(args[0]), int(args[1]), int(args[2]))
        b = jax_plan_hbm_budget(int(args[0]), int(args[1]), int(args[2]))
        assert (a.total_bytes, a.weights_bytes, a.kv_bytes) == \
            (b.total_bytes, b.weights_bytes, b.kv_bytes)
    with pytest.raises(MemoryError):
        plan_hbm_budget(10, 10, 1)

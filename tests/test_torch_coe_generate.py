"""The port's LMRouter and CompositionOfExperts.generate against the JAX
package's, on the CPU, on the same expert and router trees (through numpy)
and prompts.

``LMRouter.logits`` agree within ATOL = 1e-4 at f32 (4 layers of the
reduced backbone; the frameworks sum in different orders) and ``route``
exactly. ``generate`` must give identical tokens, expert indices and
weight-cache hit / miss counts. It runs at f32: at bf16 the two frameworks
round the products differently and a greedy argmax flips within a few
tokens. The JAX dense cache is bf16 whatever the weights and its
decode_step refuses an f32 token into it, so for this comparison both
packages' ``cache_spec`` is patched (in this process only) to give the
cache the weights' type, f32."""
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
from repro.core.router import LMRouter as JaxLMRouter
from repro.models import get_model as jax_get_model
from repro.models import transformer as JT
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.core import (CompositionOfExperts, ExpertHandle,
                              GenerationResult, HashRouter, LMRouter)
from repro_torch.models import transformer as T

ATOL = 1e-4
N_EXPERTS = 3


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    m = jax_get_model(jcfg)
    rng = jax.random.PRNGKey(0)
    trees = [_f32(m.init(jax.random.fold_in(rng, i)))
             for i in range(N_EXPERTS)]
    router = JaxLMRouter(jcfg, N_EXPERTS)
    router_tree = _f32(router.init(jax.random.PRNGKey(11)))
    toks = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (6, 8)).astype(np.int32)
    return (jcfg, reduced(get_config("samba-coe-expert-7b")), trees, router,
            router_tree, toks)


def test_lm_router_logits_and_route_match_jax(setup):
    jcfg, cfg, _, jrouter, rtree, toks = setup
    router = LMRouter(cfg, N_EXPERTS)
    params = to_torch(rtree)
    assert params["head"].shape == (cfg.d_model, N_EXPERTS)
    specs = router.param_specs()
    assert specs["head"].shape == (cfg.d_model, N_EXPERTS)
    assert set(specs["backbone"]) == set(rtree["backbone"])
    want = np.asarray(jrouter.logits(rtree, jnp.asarray(toks)))
    got = router.logits(params, toks)
    assert got.dtype == torch.float32 and got.shape == (len(toks), N_EXPERTS)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    idx = router.route(params, toks)
    assert isinstance(idx, np.ndarray)
    assert (idx == np.asarray(jrouter.route(rtree, jnp.asarray(toks)))).all()


def _cache_like_weights(monkeypatch):
    jspec, spec = JT.cache_spec, T.cache_spec
    monkeypatch.setattr(JT, "cache_spec", lambda *a: jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), jspec(*a)))
    monkeypatch.setattr(T, "cache_spec", lambda *a: {
        k: (sh, torch.float32) for k, (sh, _) in spec(*a).items()})


@pytest.mark.parametrize("router_kind", ["hash", "lm"])
def test_generate_matches_jax(setup, router_kind, monkeypatch):
    jcfg, cfg, trees, jrouter, rtree, toks = setup
    _cache_like_weights(monkeypatch)
    nbytes = sum(a.nbytes for a in jax.tree.leaves(trees[0]))
    cap = int(2.5 * nbytes)          # two experts resident: one eviction
    if router_kind == "hash":
        jr, jrp, r, rp = JaxHashRouter(N_EXPERTS), None, \
            HashRouter(N_EXPERTS), None
    else:
        jr, jrp, r, rp = jrouter, rtree, LMRouter(cfg, N_EXPERTS), \
            to_torch(rtree)
    jcoe = JaxCoE(jr, jrp, cap)
    coe = CompositionOfExperts(r, rp, cap, device="cpu")
    for i, t in enumerate(trees):
        jcoe.register(JaxHandle(f"e{i}", jcfg, t))
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    try:
        want = jcoe.generate(toks, 5)
        got = coe.generate(toks, 5)
    finally:
        jcoe.cache.close()
        coe.cache.close()
    assert isinstance(got, GenerationResult)
    assert got.tokens.shape == (len(toks), 5)
    assert (got.expert_of_prompt == want.expert_of_prompt).all()
    assert len(np.unique(got.expert_of_prompt)) > 1   # a switch happened
    assert (got.tokens == want.tokens).all()
    js, ps = jcoe.cache.stats, coe.cache.stats
    assert (ps.hits, ps.misses, ps.prefetch_hits) == \
        (js.hits, js.misses, js.prefetch_hits)
    assert ps.hits + ps.misses == len(np.unique(got.expert_of_prompt))
    assert got.route_seconds >= 0 and got.exec_seconds > 0

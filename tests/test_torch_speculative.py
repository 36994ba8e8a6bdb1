"""Speculative decoding in the port against the JAX package, on the CPU, on
the same f32 target and draft weights (JAX init through ``bridge``):

  * the engine policy ``SpeculativeDecode`` (gamma 3, a 2-layer draft) on
    the paged slots: the port's drain (reference backend, which the draft
    inherits) and JAX's (XLA backend) give identical streams and equal
    ``SpecStats``; the port's speculative drain equals its own greedy drain,
    under the reference backend and under the default fused backend (the
    kernels' plain versions on the CPU); a self-draft accepts every
    proposal;
  * the standalone dense-cache ``SpeculativeDecoder`` against JAX's and
    against the port's dense greedy decode. JAX's dense cache is bf16
    whatever the weights and its ``decode_step`` refuses an f32 token into
    it, so, as ``test_torch_coe_generate.py`` does, both packages'
    ``cache_spec`` is patched (in this test only) to give the cache the
    weights' type, f32; the reduced expert as the target, and JAX's own
    cases (``tests/test_speculative.py``) with the reduced granite-8b as
    the target: a 2-layer draft of d_ff 128 and a self-draft, the drafts'
    steps on the dense kernels' route (their plain versions here)."""
import dataclasses

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
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SpeculativeDecode as JaxSpecDecode
from repro.serving.speculative import SpeculativeDecoder as JaxSpecDecoder
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.serving import (Request, ServingEngine, SpeculativeDecode,
                                 SpeculativeDecoder, XlaPagedBackend)

ENGINE = dict(max_len=48, n_slots=3, block_size=8)
GAMMA = 3


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    cfg = reduced(get_config("samba-coe-expert-7b"))
    jd = dataclasses.replace(jcfg, n_layers=2)
    d = dataclasses.replace(cfg, n_layers=2)
    rng = jax.random.PRNGKey(0)
    trees = [_f32(jax_get_model(jcfg).init(jax.random.fold_in(rng, i)))
             for i in range(2)]
    draft = _f32(jax_get_model(jd).init(jax.random.fold_in(rng, 7)))
    nbytes = sum(a.nbytes for a in jax.tree.leaves(trees[0]))
    return jcfg, cfg, jd, d, trees, draft, nbytes


def _requests(cls, vocab):
    rs = np.random.RandomState(5)
    return [cls(rid=i, tokens=rs.randint(0, vocab, (5 + 3 * i,))
                .astype(np.int32), max_new_tokens=4 + 2 * (i % 3),
                expert=f"e{i % 2}") for i in range(5)]


def _jax_drain(models, policy):
    jcfg, _, _, _, trees, _, nbytes = models
    coe = JaxCoE(JaxHashRouter(2), None, int(2.5 * nbytes))
    for i, t in enumerate(trees):
        coe.register(JaxHandle(f"e{i}", jcfg, t))
    eng = JaxEngine(coe, jcfg, backend="xla", kv_dtype=jnp.float32,
                    policy=policy, **ENGINE)
    for r in _requests(JaxRequest, jcfg.vocab_size):
        eng.submit(r)
    out = {r.rid: r.output for r in eng.drain()}
    coe.cache.close()
    return out, eng


def _port_drain(models, policy, backend="xla"):
    _, cfg, _, _, trees, _, nbytes = models
    coe = CompositionOfExperts(HashRouter(2), None, int(2.5 * nbytes),
                               device="cpu")
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    eng = ServingEngine(
        coe, cfg, backend=XlaPagedBackend(cfg) if backend == "xla" else None,
        kv_dtype=torch.float32, device="cpu", policy=policy, **ENGINE)
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    out = {r.rid: r.output for r in eng.drain()}
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.check_invariants() == []
    if isinstance(policy, SpeculativeDecode):
        assert policy.d_pool.stats.blocks_in_use == 0
        assert policy.d_pool.check_invariants() == []
    coe.cache.close()
    return out, eng


def _same(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=str(rid))


def test_engine_speculative_matches_jax_and_greedy(models):
    _, _, jd, d, _, draft, _ = models
    jspec = JaxSpecDecode(jd, draft, gamma=GAMMA)
    want, _ = _jax_drain(models, jspec)
    spec = SpeculativeDecode(d, to_torch(draft), gamma=GAMMA)
    got, eng = _port_drain(models, spec)
    _same(got, want)
    assert dataclasses.asdict(spec.stats) == dataclasses.asdict(jspec.stats)
    assert spec.stats.target_calls == eng.stats.decode_rounds
    assert spec.stats.draft_calls == GAMMA * eng.stats.decode_rounds
    assert eng.runner.backend_name == spec.d_runner.backend_name == "xla"
    greedy, _ = _port_drain(models, None)
    _same(got, greedy)
    # the default (fused) backend: the draft loop goes through the kernels'
    # route (their plain versions here), the verify through the plain body
    fspec = SpeculativeDecode(d, to_torch(draft), gamma=GAMMA)
    fused, feng = _port_drain(models, fspec, backend="fused")
    assert feng.runner.backend_name == fspec.d_runner.backend_name == "fused"
    fgreedy, _ = _port_drain(models, None, backend="fused")
    _same(fused, fgreedy)
    _same(fused, greedy)


def test_engine_self_draft_accepts_every_proposal(models):
    _, cfg, _, _, trees, _, nbytes = models
    spec = SpeculativeDecode(cfg, to_torch(trees[0]), gamma=4)
    coe = CompositionOfExperts(HashRouter(1), None, int(1.5 * nbytes),
                               device="cpu")
    coe.register(ExpertHandle("e0", cfg, to_torch(trees[0])))
    eng = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                        kv_dtype=torch.float32, device="cpu", policy=spec,
                        **ENGINE)
    greedy_eng = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                               kv_dtype=torch.float32, device="cpu",
                               **ENGINE)
    outs = []
    for e in (eng, greedy_eng):
        for r in _requests(Request, cfg.vocab_size):
            r.expert = "e0"
            e.submit(r)
        outs.append({r.rid: r.output for r in e.drain()})
    _same(*outs)
    assert spec.stats.acceptance_rate == 1.0
    assert spec.stats.tokens_per_target_call > 2.0
    coe.cache.close()


def _patch_cache_f32(monkeypatch):
    jspec, spec = JT.cache_spec, T.cache_spec
    monkeypatch.setattr(JT, "cache_spec", lambda *a: jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), jspec(*a)))
    monkeypatch.setattr(T, "cache_spec", lambda *a: {
        k: (sh, torch.float32) for k, (sh, _) in spec(*a).items()})


def _dense_greedy(m, params, prompt, n):
    B, S = prompt.shape
    last, cache = m.prefill(params, {"tokens": torch.as_tensor(prompt)
                                     .long()}, S + n + 8)
    tok = torch.argmax(last, -1)
    out = [tok.numpy()]
    for t in range(n - 1):
        lg, cache = m.decode_step(params, cache, tok[:, None], S + t)
        tok = torch.argmax(lg, -1)
        out.append(tok.numpy())
    return np.stack(out, 1)


def test_standalone_decoder_matches_jax_and_dense_greedy(models,
                                                         monkeypatch):
    jcfg, cfg, jd, d, trees, draft, _ = models
    _patch_cache_f32(monkeypatch)
    rs = np.random.RandomState(0)
    for prompt, n, gamma, own in (
            (rs.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32), 10,
             3, False),
            (rs.randint(0, cfg.vocab_size, (1, 12)).astype(np.int32), 9,
             4, True)):
        jdraft_cfg, draft_cfg = (jcfg, cfg) if own else (jd, d)
        dtree = trees[0] if own else draft
        jsd = JaxSpecDecoder(jcfg, jdraft_cfg, gamma=gamma)
        want = jsd.generate(trees[0], dtree, prompt, n)
        sd = SpeculativeDecoder(cfg, draft_cfg, gamma=gamma)
        got = sd.generate(to_torch(trees[0]), to_torch(dtree), prompt, n)
        np.testing.assert_array_equal(got, want)
        assert dataclasses.asdict(sd.stats) == dataclasses.asdict(jsd.stats)
        ref = _dense_greedy(get_model(cfg), to_torch(trees[0]), prompt, n)
        np.testing.assert_array_equal(got, ref)
        if own:                              # a self-draft accepts all
            assert sd.stats.acceptance_rate == 1.0
            assert sd.stats.tokens_per_target_call > 2.0


def test_standalone_decoder_granite_target_matches_jax(monkeypatch):
    """JAX's ``test_speculative_equals_greedy`` and
    ``test_speculative_self_draft_full_acceptance`` on the reduced
    granite-8b (GQA 4 / 2), both packages on the same f32 weights."""
    _patch_cache_f32(monkeypatch)
    jt, t = jax_reduced(jax_get_config("granite-8b")), \
        reduced(get_config("granite-8b"))
    jd, d = (dataclasses.replace(c, n_layers=2, d_ff=128) for c in (jt, t))
    rng = jax.random.PRNGKey(0)
    tp = _f32(jax_get_model(jt).init(rng))
    dp = _f32(jax_get_model(jd).init(jax.random.fold_in(rng, 7)))
    for prompt, n, gamma, own in (
            (np.random.RandomState(0).randint(0, t.vocab_size, (2, 16)),
             10, 3, False),
            (np.random.RandomState(1).randint(0, t.vocab_size, (1, 12)),
             9, 4, True)):
        prompt = prompt.astype(np.int32)
        jdraft, draft, dtree = (jt, t, tp) if own else (jd, d, dp)
        jsd = JaxSpecDecoder(jt, jdraft, gamma=gamma)
        want = jsd.generate(tp, dtree, prompt, n)
        sd = SpeculativeDecoder(t, draft, gamma=gamma)
        got = sd.generate(to_torch(tp), to_torch(dtree), prompt, n)
        np.testing.assert_array_equal(got, want)
        assert dataclasses.asdict(sd.stats) == dataclasses.asdict(jsd.stats)
        np.testing.assert_array_equal(
            got, _dense_greedy(get_model(t), to_torch(tp), prompt, n))
        if own:
            assert sd.stats.acceptance_rate == 1.0
            assert sd.stats.tokens_per_target_call > 2.0

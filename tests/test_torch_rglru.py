"""The port's RecurrentGemma (rglru) family against the JAX package on the
CPU, at ``reduced(recurrentgemma-9b)`` with ``n_layers=5``: one
(rec, rec, attn) group and the 2-layer rec tail. Both packages get the same
f32 weights, states and tokens through numpy.

Tolerances: the ``lru_scan`` plain version (a doubling scan) against JAX's
Pallas kernel in interpret mode (a sequential walk) within atol 1e-5 at f32,
the two summing in different orders; blocks, logits and caches within atol
1e-4 at f32, and a cache leaf the prefill rounds to bf16 within one bf16
unit as well (an f32 value at a rounding boundary may round either way).
``generate`` must give identical greedy tokens at f32. JAX's rglru cache is
bf16 whatever the weights and its decode refuses an f32 token into it, so
the generate comparison patches both packages' ``cache_spec`` to f32 in
this process, and the decode past the window, whose prefill casts the ring
to bf16 in JAX whatever the spec, starts both packages from JAX's prefill
cache with the ring upcast to f32."""
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
from repro.kernels.lru_scan import lru_scan as jax_lru_scan
from repro.models import get_model as jax_get_model
from repro.models import rglru as JR
from repro.models.common import ParamSpec as JaxParamSpec
from repro_torch.bridge import to_numpy, to_torch, tree_leaves, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.kernels.lru_scan import lru_scan
from repro_torch.models import get_model
from repro_torch.models import rglru as R
from repro_torch.models.common import _spec_leaves

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cfgs():
    name = "recurrentgemma-9b"
    return (dataclasses.replace(jax_reduced(jax_get_config(name)), n_layers=5),
            dataclasses.replace(reduced(get_config(name)), n_layers=5))


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, _ = cfgs
    return _f32(jax_get_model(jcfg).init(jax.random.PRNGKey(5)))


def _close(got, want, atol=ATOL):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], atol)
        return
    rtol = 2.0 ** -7 if jnp.asarray(want).dtype == jnp.bfloat16 else 0
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


def test_config_and_param_tree_match_jax(cfgs, params):
    jcfg, cfg = cfgs
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "act", "sliding_window", "block_pattern",
              "d_rnn", "conv_width"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full = get_config("recurrentgemma-9b")
    assert full == dataclasses.replace(
        full, **{f.name: getattr(jax_get_config("recurrentgemma-9b"), f.name)
                 for f in dataclasses.fields(full)})
    jspecs = jax.tree_util.tree_flatten_with_path(
        jax_get_model(jcfg).param_specs(),
        is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    jshapes = {"/".join(str(p.key) for p in path): s.shape
               for path, s in jspecs}
    shapes = {k: s.shape for k, s in _spec_leaves(get_model(cfg).param_specs())}
    assert shapes == jshapes
    assert {"tail_rec", "tail_mlp"} <= set(params)


def test_bridge_round_trip_of_the_rg_tree(cfgs):
    """The bf16 tree as JAX makes it, nested stacked groups and tail trees
    included, crosses to torch and back bit for bit."""
    jcfg, _ = cfgs
    jp = jax.tree.map(np.asarray, jax_get_model(jcfg).init(
        jax.random.PRNGKey(6)))
    tp = to_torch(jp)
    assert tp["groups"]["rec"]["w_rg"].dtype == torch.bfloat16
    assert tp["groups"]["rec"]["w_rg"].shape == (1, 2, 128, 128)
    assert tp["tail_mlp"]["ffn"]["wo"].shape == (2, 256, 128)
    back = to_numpy(tp)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, a in flat:
        node = back
        for p in path:
            node = node[p.key]
        assert node.dtype == a.dtype and node.shape == a.shape
        assert np.array_equal(node.view(np.uint16), a.view(np.uint16))


def test_lru_scan_plain_matches_the_pallas_kernel():
    for i, (B, S, D) in enumerate(((2, 64, 128), (1, 256, 256), (3, 40, 128))):
        rs = np.random.RandomState(i)
        a = rs.uniform(0.0, 1.0, (B, S, D)).astype(np.float32)
        b = rs.standard_normal((B, S, D)).astype(np.float32)
        want = jax_lru_scan(jnp.asarray(a), jnp.asarray(b), interpret=True)
        got = lru_scan(torch.as_tensor(a), torch.as_tensor(b))
        _close(got, want, atol=1e-5)


def test_rec_block_scan_and_step_match_jax(cfgs, params):
    jcfg, cfg = cfgs
    jp = jax.tree.map(lambda a: a[0], params["groups"]["rec"])
    jp = jax.tree.map(lambda a: a[1], jp)          # group 0, rec layer 1
    tp = to_torch(jp)
    rs = np.random.RandomState(7)
    x = rs.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jy, jst = JR.rec_block(jcfg, jp, jnp.asarray(x))
    ty, tst = R.rec_block(cfg, tp, torch.as_tensor(x))
    _close(ty, jy)
    _close(tst, jst)
    state = {"h": rs.standard_normal((2, cfg.d_rnn)).astype(np.float32),
             "conv": rs.standard_normal(
                 (2, cfg.conv_width - 1, cfg.d_rnn)).astype(np.float32)}
    x1 = x[:, :1]
    jy, jst = JR.rec_block(jcfg, jp, jnp.asarray(x1),
                           jax.tree.map(jnp.asarray, state))
    ty, tst = R.rec_block(cfg, tp, torch.as_tensor(x1), to_torch(state))
    _close(ty, jy)
    _close(tst, jst)


def test_forward_logits_match_jax(cfgs, params):
    """At S = 40 JAX takes its quadratic attention; at S = 256
    (> 2 attn_chunk) its streaming-block form with the 32-position window.
    The port's plain attention is the quadratic oracle at both."""
    jcfg, cfg = cfgs
    tp = to_torch(params)
    for S in (40, 256):
        toks = np.random.RandomState(S).randint(
            0, cfg.vocab_size, (2, S)).astype(np.int32)
        want, (jrec, (jk, jv), jtail) = JR.forward(
            jcfg, params, {"tokens": jnp.asarray(toks)}, return_states=True)
        got, (rec, (k, v), tail) = R.forward(
            cfg, tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)},
            return_states=True)
        _close(got, want)
        _close(rec, jrec)
        _close(tail, jtail)
        _close(k, jk)
        _close(v, jv)


def test_prefill_and_decode_past_the_window_match_jax(cfgs, params):
    """S = 40 > W = 32: the ring keeps positions 8..39 rolled by 8; then
    three decode steps, both from JAX's prefill cache, write the ring at
    pos % W and attend the last W."""
    jcfg, cfg = cfgs
    tp = to_torch(params)
    S, max_len = 40, 48
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    jlast, jc = JR.prefill(jcfg, params, jnp.asarray(toks), max_len)
    last, c = R.prefill(cfg, tp, torch.as_tensor(toks, dtype=torch.long),
                        max_len)
    assert c["k"].shape[2] == 32 and c["k"].dtype == torch.bfloat16
    _close(last, jlast)
    _close(c, jc)
    jc = dict(jc, k=jc["k"].astype(jnp.float32), v=jc["v"].astype(jnp.float32))
    c = to_torch(jax.tree.map(np.asarray, jc))
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for t in range(3):
        jl, jc = JR.decode_step(jcfg, params, jc, jnp.asarray(tok[:, None]),
                                jnp.int32(S + t))
        lg, c = R.decode_step(cfg, tp, c, torch.as_tensor(tok[:, None]).long(),
                              S + t)
        _close(lg, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _close(c, jc)


def _cache_like_weights(monkeypatch):
    jspec, spec = JR.cache_spec, R.cache_spec
    monkeypatch.setattr(JR, "cache_spec", lambda *a: jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), jspec(*a)))
    monkeypatch.setattr(R, "cache_spec", lambda *a: tree_map(
        lambda s: (s[0], torch.float32), spec(*a)))


def test_generate_over_two_rg_experts_matches_jax(cfgs, monkeypatch):
    jcfg, cfg = cfgs
    _cache_like_weights(monkeypatch)
    trees = [_f32(jax_get_model(jcfg).init(jax.random.PRNGKey(20 + i)))
             for i in range(2)]
    toks = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (6, 8)).astype(np.int32)
    cap = int(1.5 * sum(a.nbytes for a in jax.tree.leaves(trees[0])))
    jcoe = JaxCoE(JaxHashRouter(2), None, cap)
    coe = CompositionOfExperts(HashRouter(2), None, cap, device="cpu")
    for i, t in enumerate(trees):
        jcoe.register(JaxHandle(f"rg{i}", jcfg, t))
        coe.register(ExpertHandle(f"rg{i}", cfg, to_torch(t)))
    try:
        want = jcoe.generate(toks, 5)
        got = coe.generate(toks, 5)
    finally:
        jcoe.cache.close()
        coe.cache.close()
    assert got.tokens.shape == (6, 5)
    assert (got.expert_of_prompt == want.expert_of_prompt).all()
    assert len(np.unique(got.expert_of_prompt)) == 2
    assert (got.tokens == want.tokens).all()
    js, ps = jcoe.cache.stats, coe.cache.stats
    assert (ps.hits, ps.misses) == (js.hits, js.misses)
    assert ps.hits + ps.misses == 2
    assert all(t.dtype == torch.float32 for t in tree_leaves(
        R.init_cache(cfg, 1, 13, "cpu")))

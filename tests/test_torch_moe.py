"""The port's MoE family (Mixtral-8x7B) and the dense cache's sliding-window
ring against the JAX package, on the CPU, at ``reduced(mixtral-8x7b)``
size (window 32, 4 experts, top-2, ``moe_d_ff`` 64). Both packages get
JAX's init through numpy (``bridge.to_torch``), in f32 unless a case says
otherwise:

  * configs, ``reduced`` and parameter specs (shapes, dtypes, axes, fan-in,
    bytes) equal JAX's;
  * ``moe_apply`` against JAX's at ``capacity_factor`` 0.5, 1.25 and 16,
    with and without a shared expert and ``routed_scale`` 0.7: the same
    top-k choices and drop sets, the output within 1e-5 of the largest
    |output| in f32 and within 2^-6 of it in bf16 (each framework rounds
    an expert's gate / up products, its hidden, its down product and the
    weighted term to bf16 on its own, then sums two terms in f32: a value
    parts by up to two units in the last place, 0.0085 of the largest
    here); the 0.5 case drops assignments, so its output differs from the
    16 case's;
  * the combine weights sum to 1 per token (the port's counterpart of
    ``tests/test_substrate.py::test_moe_routing_weights_sum``);
  * forward logits and per-layer K/V within atol 1e-4 (f32; the two
    frameworks sum in other orders), the capacity dropping assignments;
  * ``prefill`` and ``decode_step`` with S 40 past a window of 24 and with
    S 16 inside it (the decode then wraps the ring): ring contents and
    logits within atol 1e-4, the ring an exact roll of the forward's K/V;
    one step past the window against the teacher-forced forward at
    ``capacity_factor`` 16, as ``tests/test_arch_smoke.py::
    test_swa_ring_cache_matches_full`` holds JAX's (within 1e-4 of the
    largest logit here, f32);
  * ``CompositionOfExperts.generate`` over two MoE experts: tokens, expert
    indices and cache counts equal to JAX's.

JAX's dense cache is bf16 whatever the weights (and its decode refuses an
f32 token into it), so where a case decodes both packages' ``cache_spec``
is patched to f32 in this process only, as ``test_torch_coe_generate.py``
does."""
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.common import ParamSpec as JaxSpec
from repro.models.common import init_params as jax_init
from repro.models.common import param_bytes as jax_param_bytes
from repro_torch.bridge import to_torch
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.models import common, get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH = "mixtral-8x7b"
ATOL = 1e-4
MOE_TOL_REL = {"f32": 1e-5, "bf16": 2.0 ** -6}
CAPACITY = (0.5, 1.25, 16.0)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    return _f32(jax_get_model(jcfg).init(jax.random.PRNGKey(3)))


def _cache_f32(monkeypatch):
    jspec, spec = JT.cache_spec, T.cache_spec
    monkeypatch.setattr(JT, "cache_spec", lambda *a: jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), jspec(*a)))
    monkeypatch.setattr(T, "cache_spec", lambda *a: {
        k: (sh, torch.float32) for k, (sh, _) in spec(*a).items()})


def _flat_specs(specs, prefix=""):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_flat_specs(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: specs}


def _dropped(cfg, xt):
    """How many (token, choice) assignments of xt (T, D) exceed their
    expert's capacity."""
    _, _, topi = L.moe_route(cfg, torch.tensor(xt["router"]),
                             torch.as_tensor(xt["x"]))
    counts = torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
    C = L.moe_capacity(cfg, xt["x"].shape[0])
    return int((counts - C).clamp_min(0).sum())


def test_configs_and_specs_match_jax():
    fields = [f.name for f in dataclasses.fields(CONFIGS[ARCH])]
    for red in (False, True):
        jcfg, cfg = _cfgs() if red else (jax_get_config(ARCH),
                                         get_config(ARCH))
        for f in fields:
            assert getattr(cfg, f) == getattr(jcfg, f), (red, f)
        for shared in (0, 1):
            jc, c = (dataclasses.replace(x, n_shared_experts=shared)
                     for x in (jcfg, cfg))
            specs = _flat_specs(get_model(c).param_specs())
            jspecs = {"/".join(str(p.key) for p in path): s
                      for path, s in jax.tree_util.tree_flatten_with_path(
                          jax_get_model(jc).param_specs(),
                          is_leaf=lambda x: isinstance(x, JaxSpec))[0]}
            assert specs.keys() == jspecs.keys()
            assert ("layers/mlp/shared/wo" in specs) == bool(shared)
            for k, s in specs.items():
                js = jspecs[k]
                assert (s.shape, s.axes, s.init, s.fan_in_axes) == \
                    (js.shape, js.axes, js.init, js.fan_in_axes), (red, k)
                assert torch.empty((), dtype=s.dtype).element_size() == \
                    np.dtype(js.dtype).itemsize, k
            assert specs["layers/mlp/router"].dtype == torch.float32
            assert common.param_bytes(get_model(c).param_specs()) == \
                jax_param_bytes(jax_get_model(jc).param_specs())
    # the whole model: 46.7 G parameters, 93.4 GB of bf16
    full = common.param_bytes(get_model(get_config(ARCH)).param_specs())
    assert full == jax_param_bytes(jax_get_model(
        jax_get_config(ARCH)).param_specs())
    assert 93.3e9 < full < 93.5e9


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_apply_matches_jax(dtype):
    """The routed FFN alone, B 3 x S 7 tokens (T 21: C 6 / 14 / 21 at cf
    0.5 / 1.25 / 16); a shared expert and ``routed_scale`` 0.7 in a second
    config."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rs = np.random.RandomState(5)
    outs = {}
    for shared, scale in ((0, 1.0), (1, 0.7)):
        for cf in CAPACITY:
            jcfg, cfg = _cfgs(n_shared_experts=shared, routed_scale=scale,
                              capacity_factor=cf)
            p = _f32(jax_init(jax.random.PRNGKey(7), JL.moe_specs(jcfg)))
            if dtype == "bf16":       # the router stays f32, as specified
                p = jax.tree_util.tree_map_with_path(
                    lambda path, a: a if path[-1].key == "router"
                    else np.array(jnp.asarray(a, jnp.bfloat16)), p)
            x = rs.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
            jx = jnp.asarray(x, jdt)
            xt = np.array(jx, np.float32).reshape(-1, cfg.d_model)
            want = np.asarray(JL.moe_apply(jcfg, p, jx), np.float32)
            got = L.moe_apply(cfg, to_torch(p), torch.as_tensor(xt).to(tdt)
                              .reshape(3, 7, cfg.d_model))
            assert got.dtype == tdt and got.shape == (3, 7, cfg.d_model)
            # the same choices, hence the same drop sets
            jl = np.asarray(jx.reshape(-1, cfg.d_model).astype(jnp.float32)
                            @ p["router"])
            _, jtop = jax.lax.top_k(jax.nn.softmax(jnp.asarray(jl)), 2)
            _, _, top = L.moe_route(cfg, torch.tensor(p["router"]),
                                    torch.as_tensor(xt).to(tdt))
            np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
            tol = MOE_TOL_REL[dtype] * float(np.abs(want).max())
            np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                       rtol=0, err_msg=f"{shared} {cf}")
            outs[shared, cf] = (got.float().numpy(), _dropped(
                cfg, {"router": p["router"], "x": xt}))
        # cf 0.5 drops assignments, 16 none: the outputs differ
        assert outs[shared, 0.5][1] > 0 and outs[shared, 16.0][1] == 0
        assert np.abs(outs[shared, 0.5][0] - outs[shared, 16.0][0]).max() \
            > 0.1 * np.abs(outs[shared, 16.0][0]).max()


def test_combine_weights_sum_to_one():
    """Top-k combine weights (after Mixtral's renormalisation) sum to 1
    per token; the output is finite and of x's shape (cf 16, bf16 x)."""
    _, cfg = _cfgs(capacity_factor=16.0)
    p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    mp = T.layer_params(p, 0)["mlp"]
    for b, s in ((2, 1), (3, 2), (5, 3)):
        x = torch.as_tensor(np.random.RandomState(b).randn(b, s, cfg.d_model),
                            dtype=torch.float32)
        _, w, top = L.moe_route(cfg, mp["router"], x.reshape(-1, cfg.d_model))
        assert w.dtype == torch.float32 and top.shape == (b * s, 2)
        torch.testing.assert_close(w.sum(-1), torch.ones(b * s), atol=1e-6,
                                   rtol=0)
        out = L.moe_apply(cfg, mp, x.to(torch.bfloat16))
        assert out.shape == x.shape and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_and_cache_match_jax(params, last_only):
    """Two rows of 40 tokens past the 32-position window: the window mask
    and the capacity (C 50 of T 80 at cf 1.25, which drops) both act."""
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jc = JT.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                        return_cache=True, last_only=last_only)
    tl, tc = T.forward(cfg, to_torch(params),
                       {"tokens": torch.as_tensor(toks, dtype=torch.long)},
                       return_cache=True, last_only=last_only)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    (jk, jv), (tk, tv) = jc[0], tc[0]
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("S", [40, 16])
def test_ring_prefill_and_decode_match_jax(params, S, monkeypatch):
    """Window 24: S 40 keeps positions 16..39 rolled by 16; S 16 fills
    the ring's first 16 entries and the 12 decode steps wrap it at 24."""
    _cache_f32(monkeypatch)
    jcfg, cfg = _cfgs(sliding_window=24)
    W, steps, max_len = 24, 12, 64
    tp = to_torch(params)
    toks = np.random.RandomState(S).randint(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    jlast, jc = JT.prefill(jcfg, params, jnp.asarray(toks), max_len)
    tt = torch.as_tensor(toks, dtype=torch.long)
    last, c = T.prefill(cfg, tp, tt, max_len)
    assert c["k"].shape == (cfg.n_layers, 2, W, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL,
                               rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL, rtol=0)
    # the ring holds position p at p % W: an exact roll of the forward's
    _, fc = T.forward(cfg, tp, {"tokens": tt}, return_cache=True)
    for n, full in zip(("k", "v"), fc[0]):
        if S > W:
            want = torch.roll(full[:, :, S - W:], (S - W) % W, dims=2)
        else:
            want = full
        assert torch.equal(c[n][:, :, :min(S, W)], want)
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for t in range(steps):
        jl, jc = JT.decode_step(jcfg, params, jc, jnp.asarray(tok[:, None]),
                                jnp.int32(S + t))
        lg, c = T.decode_step(cfg, tp, c, torch.as_tensor(tok[:, None]).long(),
                              S + t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert S + steps > W                 # the ring wrapped
    for n in ("k", "v"):
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL, rtol=0)


def test_ring_decode_matches_the_windowed_forward(params, monkeypatch):
    """JAX's ``test_swa_ring_cache_matches_full`` on the port: window 24,
    S 40, one step at position 40 against the teacher-forced forward over
    41 tokens, at ``capacity_factor`` 16 (no drops: a step and a forward
    count different tokens). f32 here, so within 1e-4 of the largest
    logit, where JAX's bf16 run allows 5 %."""
    _cache_f32(monkeypatch)
    _, cfg = _cfgs(sliding_window=24, capacity_factor=16.0)
    tp = to_torch(params)
    toks = torch.as_tensor(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (1, 42)), dtype=torch.long)
    full = T.forward(cfg, tp, {"tokens": toks})
    _, cache = T.prefill(cfg, tp, toks[:, :40], 48)
    lg, cache = T.decode_step(cfg, tp, cache, toks[:, 40:41], 40)
    err = float((lg - full[:, 40]).abs().max())
    assert err <= ATOL * float(full.abs().max()), err
    # without the window the step attends all 41 positions and parts
    _, wide = _cfgs(capacity_factor=16.0, sliding_window=0)
    assert float((T.forward(wide, tp, {"tokens": toks})[:, 40]
                  - full[:, 40]).abs().max()) > 100 * err


def test_generate_over_two_moe_experts_matches_jax(monkeypatch):
    """Six 30-token prompts, 8 new tokens: each group's decode crosses the
    32-position ring's wrap; the capacity counts each group's rows."""
    _cache_f32(monkeypatch)
    jcfg, cfg = _cfgs()
    trees = [_f32(jax_get_model(jcfg).init(jax.random.PRNGKey(30 + i)))
             for i in range(2)]
    toks = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (6, 30)).astype(np.int32)
    cap = int(1.5 * sum(a.nbytes for a in jax.tree.leaves(trees[0])))
    jcoe = JaxCoE(JaxHashRouter(2), None, cap)
    coe = CompositionOfExperts(HashRouter(2), None, cap, device="cpu")
    for i, t in enumerate(trees):
        jcoe.register(JaxHandle(f"m{i}", jcfg, t))
        coe.register(ExpertHandle(f"m{i}", cfg, to_torch(t)))
    try:
        want = jcoe.generate(toks, 8)
        got = coe.generate(toks, 8)
    finally:
        jcoe.cache.close()
        coe.cache.close()
    assert got.tokens.shape == (6, 8)
    assert (got.expert_of_prompt == want.expert_of_prompt).all()
    assert len(np.unique(got.expert_of_prompt)) == 2
    assert (got.tokens == want.tokens).all()
    js, ps = jcoe.cache.stats, coe.cache.stats
    assert (ps.hits, ps.misses) == (js.hits, js.misses)

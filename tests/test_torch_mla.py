"""The port's MLA family (DeepSeek-V2-Lite: latent KV cache, absorbed
decode, a dense head layer before the MoE layers) against the JAX package,
on the CPU, at ``reduced(deepseek-v2-lite-16b)`` size (4 layers, the first
dense; ``kv_lora_rank`` 64, ``qk_nope_dim`` 32, ``qk_rope_dim`` 16,
``v_head_dim`` 32; 4 experts top-2 with a shared one, no renormalisation).
Both packages get JAX's init through numpy (``bridge.to_torch``), in f32:

  * configs, ``reduced``, parameter specs (shapes, dtypes, axes, fan-in,
    bytes) and cache specs equal JAX's; the whole model is 31.4 GB of bf16;
  * ``ops.attention`` at dk 48, dv 32 (the plain version on the CPU)
    against JAX's ``L.attention`` on both of its branches, the quadratic
    one and the block one (``attn_chunk`` 16 over S 64): within 1e-5;
  * ``_mla_attn`` (its output and its c_kv / k_rope) and
    ``_mla_attn_decode`` (its output and both updated caches) against
    JAX's: within 1e-5;
  * forward logits (whole and ``last_only``) and the per-stack cache trees:
    within atol 1e-4 (the frameworks sum in other orders);
  * ``prefill`` then 6 ``decode_step``s: logits and the four cache entries
    within atol 1e-4 after every step; the absorbed step against the
    expanded teacher-forced forward, at ``capacity_factor`` 16 (a step and
    a forward count different tokens, so only a capacity that drops
    nothing gives both the same FFN), within 1e-4 of the largest logit,
    and ``chip_smoke.py``'s per-layer check of the step's latent context
    against the expanded form within 1e-5, a planted scale above its
    limit;
  * ``CompositionOfExperts.generate`` over two MLA experts: tokens, expert
    indices and cache counts equal to JAX's;
  * the serving runners refuse the family with JAX's words.

JAX's cache is bf16 whatever the weights (and its decode refuses an f32
token into it), so where a case decodes both packages' ``cache_spec`` is
patched to f32 in this process only, as ``test_torch_coe_generate.py``
does."""
import dataclasses
import importlib.util
import pathlib

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
from repro.models.common import param_bytes as jax_param_bytes
from repro.serving import backends as JB
from repro.serving import prefill as JP
from repro_torch.bridge import to_torch
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import common, get_model
from repro_torch.models import transformer as T
from repro_torch.serving.backends import PagedDecodeRunner, XlaPagedBackend
from repro_torch.serving.prefill import PackedPrefillRunner

ARCH = "deepseek-v2-lite-16b"
ATOL = 1e-4
LAYER_ATOL = 1e-5


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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (it imports torch and
    numpy only; nothing runs on import)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=msg)


def test_configs_specs_and_caches_match_jax():
    fields = [f.name for f in dataclasses.fields(CONFIGS[ARCH])]
    for red in (False, True):
        jcfg, cfg = _cfgs() if red else (jax_get_config(ARCH),
                                         get_config(ARCH))
        for f in fields:
            assert getattr(cfg, f) == getattr(jcfg, f), (red, f)
        assert cfg.q_dim == jcfg.q_dim
        specs = _flat(get_model(cfg).param_specs())
        jspecs = {"/".join(str(p.key) for p in path): s
                  for path, s in jax.tree_util.tree_flatten_with_path(
                      jax_get_model(jcfg).param_specs(),
                      is_leaf=lambda x: isinstance(x, JaxSpec))[0]}
        assert specs.keys() == jspecs.keys()
        assert "dense_layers/mlp/wi_gate" in specs
        assert "layers/mlp/shared/wo" in specs
        for k, s in specs.items():
            js = jspecs[k]
            assert (s.shape, s.axes, s.init, s.fan_in_axes) == \
                (js.shape, js.axes, js.init, js.fan_in_axes), (red, k)
            assert torch.empty((), dtype=s.dtype).element_size() == \
                np.dtype(js.dtype).itemsize, k
        cache = get_model(cfg).cache_spec(3, 40)
        jcache = jax_get_model(jcfg).cache_spec(3, 40)
        assert cache.keys() == jcache.keys() == {"ckv", "krope", "ckv0",
                                                 "krope0"}
        for k, (sh, dt) in cache.items():
            assert sh == jcache[k].shape and dt == torch.bfloat16, k
    # the whole model: 15.7 G parameters, 31.4 GB of bf16
    full = common.param_bytes(get_model(get_config(ARCH)).param_specs())
    assert full == jax_param_bytes(jax_get_model(
        jax_get_config(ARCH)).param_specs())
    assert 31.3e9 < full < 31.5e9


@pytest.mark.parametrize("branch", ["naive", "block"])
def test_attention_at_dk_48_dv_32_matches_jax(branch):
    """JAX's ``L.attention`` takes its block branch where S > 2 *
    attn_chunk and S % attn_chunk == 0; the port's plain version is the
    quadratic oracle either way. 8 q heads on 4 kv heads (G 2)."""
    rs = np.random.RandomState(1)
    S, chunk = (24, 64) if branch == "naive" else (64, 16)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                               attn_chunk=chunk)
    q = rs.standard_normal((2, S, 8, 48)).astype(np.float32)
    k = rs.standard_normal((2, S, 4, 48)).astype(np.float32)
    v = rs.standard_normal((2, S, 4, 32)).astype(np.float32)
    want = np.asarray(JL.attention(jcfg, *map(jnp.asarray, (q, k, v))))
    got = ops.attention(*map(torch.as_tensor, (q, k, v)))
    assert got.shape == (2, S, 8, 32)
    _close(got.numpy(), want, LAYER_ATOL)


def test_mla_attn_and_absorbed_decode_match_jax(params):
    """One MLA block of the MoE stack over a 20-token input, then a decode
    at position 12 over caches filled to 12 (the rest random: masked)."""
    jcfg, cfg = _cfgs()
    rs = np.random.RandomState(2)
    jp = jax.tree.map(lambda a: a[1], params["layers"]["attn"])
    tp = to_torch(jp)
    x = rs.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20)[None], (2, 1))
    jy, (jc, jr) = JT._mla_attn(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    y, (c, r) = T._mla_attn(cfg, tp, torch.as_tensor(x),
                            torch.as_tensor(pos))
    assert c.shape == (2, 20, 64) and r.shape == (2, 20, 16)
    for g, w in ((y, jy), (c, jc), (r, jr)):
        _close(g.numpy(), w, LAYER_ATOL)
    S, p = 24, 12
    x1 = rs.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ckv = rs.standard_normal((2, S, 64)).astype(np.float32)
    kr = rs.standard_normal((2, S, 16)).astype(np.float32)
    valid = np.broadcast_to(np.arange(S)[None] <= p, (2, S))
    jy, jckv, jkr = JT._mla_attn_decode(
        jcfg, jp, jnp.asarray(x1), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.int32(p), jnp.asarray(valid))
    tckv, tkr = torch.as_tensor(ckv), torch.as_tensor(kr)
    y = T._mla_attn_decode(cfg, tp, torch.as_tensor(x1), tckv, tkr, p)
    for g, w in ((y, jy), (tckv, jckv), (tkr, jkr)):
        _close(g.numpy(), w, LAYER_ATOL)


def test_forward_logits_and_cache_trees_match_jax(params):
    """Two rows of 40 tokens: the dense head layer, then three MoE layers
    (C 50 of T 80 at cf 1.25)."""
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    tp = to_torch(params)
    assert _flat(tp).keys() == _flat(params).keys()
    for last_only in (False, True):
        jl, jc = JT.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                            return_cache=True, last_only=last_only)
        tl, tc = T.forward(cfg, tp, {"tokens": torch.as_tensor(
            toks, dtype=torch.long)}, return_cache=True, last_only=last_only)
        _close(tl.numpy(), jl, msg=str(last_only))
        assert len(tc) == len(jc) == 2
        for (tcc, tkr), (jcc, jkr) in zip(tc, jc):
            assert tcc.shape == jcc.shape and tkr.shape == jkr.shape
            _close(tcc.numpy(), jcc)
            _close(tkr.numpy(), jkr)


def test_prefill_and_decode_steps_match_jax(params, monkeypatch):
    _cache_f32(monkeypatch)
    jcfg, cfg = _cfgs()
    tp = to_torch(params)
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jlast, jc = JT.prefill(jcfg, params, jnp.asarray(toks), 40)
    last, c = T.prefill(cfg, tp, torch.as_tensor(toks).long(), 40)
    _close(last.numpy(), jlast)
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for t in range(6):
        jl, jc = JT.decode_step(jcfg, params, jc, jnp.asarray(tok[:, None]),
                                jnp.int32(24 + t))
        lg, c = T.decode_step(cfg, tp, c, torch.as_tensor(tok[:, None]).long(),
                              24 + t)
        _close(lg.numpy(), jl, msg=f"step {t}")
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert c.keys() == jc.keys()
    for k in c:
        assert c[k].shape == jc[k].shape
        _close(c[k].numpy(), jc[k], msg=k)


def test_absorbed_step_matches_the_expanded_forward(params, monkeypatch):
    """A step at position 30 after a 30-token prefill against the
    teacher-forced forward over 31 tokens, at capacity_factor 16."""
    _cache_f32(monkeypatch)
    _, cfg = _cfgs(capacity_factor=16.0)
    tp = to_torch(params)
    toks = torch.as_tensor(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (2, 31)), dtype=torch.long)
    full = T.forward(cfg, tp, {"tokens": toks})[:, 30]
    _, cache = T.prefill(cfg, tp, toks[:, :30], 36)
    lg, cache = T.decode_step(cfg, tp, cache, toks[:, 30:31], 30)
    err = float((lg - full).abs().max())
    assert err <= ATOL * float(full.abs().max()), err
    # the entries past the step stay empty
    assert not cache["ckv"][:, :, 31:].any()
    # chip_smoke.py's per-layer check of the step, run here in f32: each
    # layer's latent context within 1e-5 (row relative L2) of the expanded
    # form, and the scores planted at 1/sqrt(nope) above the card's limit
    smoke = _chip_smoke()
    with smoke.decode_context_checked() as errs:
        T.decode_step(cfg, tp, cache, toks[:, 30:31], 30)
    assert len(errs) == cfg.n_layers and max(errs) <= LAYER_ATOL, errs
    with smoke.decode_scale_planted(cfg.qk_nope_dim + cfg.qk_rope_dim,
                                    cfg.qk_nope_dim), \
            smoke.decode_context_checked() as errs:
        T.decode_step(cfg, tp, cache, toks[:, 30:31], 30)
    assert min(errs) > smoke.DEEPSEEK_CTX_ROW_REL_L2, errs


def test_generate_over_two_mla_experts_matches_jax(monkeypatch):
    """Six 20-token prompts, 8 new tokens, two experts."""
    _cache_f32(monkeypatch)
    jcfg, cfg = _cfgs()
    trees = [_f32(jax_get_model(jcfg).init(jax.random.PRNGKey(40 + i)))
             for i in range(2)]
    toks = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (6, 20)).astype(np.int32)
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


def test_serving_runners_refuse_mla_as_jax_does():
    """JAX serves the MLA family on no paged path; the port's runners
    refuse it with the same words."""
    jcfg, cfg = _cfgs()
    msg = "dense/moe families only"
    for make in (lambda: JB.PagedDecodeRunner(jcfg, 0),
                 lambda: PagedDecodeRunner(cfg, 0, XlaPagedBackend(cfg)),
                 lambda: JP.PackedPrefillRunner(jcfg, buckets=(16, 32)),
                 lambda: PackedPrefillRunner(cfg, buckets=(16, 32))):
        with pytest.raises(ValueError, match=msg):
            make()

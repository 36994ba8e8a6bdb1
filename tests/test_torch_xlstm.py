"""The port's xLSTM family against the JAX package on the CPU, at
``reduced(xlstm-1.3b)``: 4 blocks (one group of 3 mLSTM and 1 sLSTM),
D 128, 2 mLSTM heads of 128, 4 sLSTM heads of 32. Both packages get the
same weights, inputs and states through numpy; the model's weights are
JAX's init moved by seeded noise (so the zero-initialised biases and the
unit norm scales are exercised too).

Tolerances:
  * ``mlstm_chunkwise`` (with and without a carried state), in f32 and
    under ``PerfOptions.mlstm_bf16``: within atol 1e-4, rtol 1e-4 (the
    frameworks sum in other orders; at the same bf16 rounding points);
  * the model's logits (also under ``mlstm_bf16``), its state tree leaf
    by leaf and three decode steps, on f32 weights: within 2^-8 of the
    largest value
    (``MODEL_REL``). The model rounds to bf16 inside, as JAX's does (the
    per-head norm's output, the sLSTM's recurrent h), where an f32
    difference of 1e-5 (each block's reading) flips a rounding; the
    readings are 1e-4 to 9e-4;
  * ``mlstm_step`` on bf16 q / k / v against f32 state, at dh 128: within
    1e-5 of the largest value. Its ``k ⊗ v`` is a bf16 product and
    ``q / sqrt(dh)`` a bf16 product with the scale rounded to bf16 (JAX's
    weak type); a port that kept either in f32 reads 1e-3 to 3e-3;
  * ``slstm_apply`` on bf16 weights and input: within 2^-6 of the largest
    value (bf16 outputs; the frameworks round the bf16 products and sums
    at the same points, XLA's CPU backend with excess precision inside
    fused chains);
  * ``CompositionOfExperts.generate``: the same greedy tokens;
  * ``chip_smoke.py``'s xLSTM checks, here at the reduced width on f32
    weights: a block against its f32 reference exactly, the chunkwise
    core against its f64 parallel form (the first also against the step
    recurrence) and three decode steps against the teacher-forced blocks
    within 1e-4 (they sum in other orders)."""
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
from repro.distributed import ctx as jctx
from repro.core import CompositionOfExperts as JaxCoE
from repro.core import ExpertHandle as JaxHandle
from repro.core import HashRouter as JaxHashRouter
from repro.models import get_model as jax_get_model
from repro.models import xlstm as JX
from repro.models.common import ParamSpec as JaxSpec
from repro.models.common import param_bytes as jax_param_bytes
from repro_torch.bridge import to_torch
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.distributed import ctx
from repro_torch.models import common, get_model
from repro_torch.models import xlstm as X

ARCH = "xlstm-1.3b"
TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_REL = 2.0 ** -8
# how far mlstm_bf16 must move the chunkwise core from the f32 one: bf16
# q, k, v move h and C by ~0.03 at unit inputs
BF16_MOVES = 1e-3


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


def _init(seed):
    """JAX's init of the reduced model moved by seeded noise, in f32."""
    jcfg, _ = _cfgs()
    tree = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.05 * rs.
                                   standard_normal(a.shape)).astype(
                                       np.float32), tree)


@pytest.fixture(scope="module")
def params():
    return _init(3)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _close(got, want, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               err_msg=msg, **(tol or TOL))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _gates(rs, B, S, H):
    il = (rs.standard_normal((B, S, H)) * 0.5).astype(np.float32)
    fl = np.asarray(jax.nn.log_sigmoid(rs.standard_normal((B, S, H))),
                    np.float32)
    return il, fl


def test_configs_specs_and_caches_match_jax():
    fields = [f.name for f in dataclasses.fields(CONFIGS[ARCH])]
    for red in (False, True):
        jcfg, cfg = _cfgs() if red else (jax_get_config(ARCH),
                                         get_config(ARCH))
        for f in fields:
            assert getattr(cfg, f) == getattr(jcfg, f), (red, f)
        specs = _flat(get_model(cfg).param_specs())
        jspecs = {"/".join(str(p.key) for p in path): s
                  for path, s in jax.tree_util.tree_flatten_with_path(
                      jax_get_model(jcfg).param_specs(),
                      is_leaf=lambda x: isinstance(x, JaxSpec))[0]}
        assert specs.keys() == jspecs.keys()
        for k, s in specs.items():
            js = jspecs[k]
            assert (s.shape, s.axes, s.init, s.fan_in_axes) == \
                (js.shape, js.axes, js.init, js.fan_in_axes), (red, k)
            assert torch.empty((), dtype=s.dtype).element_size() == \
                np.dtype(js.dtype).itemsize, k
        cache = _flat(get_model(cfg).cache_spec(3, 40))
        jcache = _flat(jax_get_model(jcfg).cache_spec(3, 40))
        assert cache.keys() == jcache.keys()
        for k, (sh, dt) in cache.items():
            assert sh == jcache[k].shape, k
            assert torch.empty((), dtype=dt).element_size() == \
                np.dtype(jcache[k].dtype).itemsize, k
        st = get_model(cfg).init_cache(3, 40, "cpu")
        jst = jax_get_model(jcfg).init_cache(3, 40)
        for k, v in _flat(st).items():
            _close(v.float().numpy(), _flat(jst)[k], k, atol=0, rtol=0)
    # the whole model: 1.99 G parameters, 3.97 GB of bf16
    full = common.param_bytes(get_model(get_config(ARCH)).param_specs())
    assert full == jax_param_bytes(jax_get_model(
        jax_get_config(ARCH)).param_specs())
    assert 3.96e9 < full < 3.98e9


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_matches_jax(carried):
    """B 2, S 64 in chunks of 16, 2 heads of 16, f32; from zeros or from a
    random carried state."""
    rs = np.random.RandomState(int(carried))
    B, S, H, dh = 2, 64, 2, 16
    q, k, v = (rs.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    il, fl = _gates(rs, B, S, H)
    st = None
    if carried:
        st = {"C": rs.standard_normal((B, H, dh, dh)).astype(np.float32),
              "n": np.abs(rs.standard_normal((B, H, dh))).astype(np.float32)}
    jh, jst = JX.mlstm_chunkwise(
        *map(jnp.asarray, (q, k, v, il, fl)),
        None if st is None else {k_: jnp.asarray(a) for k_, a in st.items()},
        chunk=16)
    h, tst = X.mlstm_chunkwise(
        *map(torch.as_tensor, (q, k, v, il, fl)),
        None if st is None else {k_: torch.as_tensor(a).clone()
                                 for k_, a in st.items()}, chunk=16)
    assert h.dtype == torch.float32
    _close(h.numpy(), jh)
    for k_ in ("C", "n"):
        _close(tst[k_].numpy(), jst[k_], k_)


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_matches_jax_under_mlstm_bf16(carried):
    """``PerfOptions.mlstm_bf16`` in both packages: the chunkwise core at
    ``test_mlstm_chunkwise_matches_jax``'s shapes within TOL of JAX's
    (readings ~1e-6: the same bf16 rounding points, f32 sums in other
    orders), and more than BF16_MOVES from the f32 core (readings ~0.03)."""
    rs = np.random.RandomState(int(carried))
    B, S, H, dh = 2, 64, 2, 16
    q, k, v = (rs.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    il, fl = _gates(rs, B, S, H)
    st = None
    if carried:
        st = {"C": rs.standard_normal((B, H, dh, dh)).astype(np.float32),
              "n": np.abs(rs.standard_normal((B, H, dh))).astype(np.float32)}

    def port():
        return X.mlstm_chunkwise(
            *map(torch.as_tensor, (q, k, v, il, fl)),
            None if st is None else {k_: torch.as_tensor(a).clone()
                                     for k_, a in st.items()}, chunk=16)

    with jctx.perf_options(jctx.PerfOptions(mlstm_bf16=True)):
        jh, jst = JX.mlstm_chunkwise(
            *map(jnp.asarray, (q, k, v, il, fl)),
            None if st is None else {k_: jnp.asarray(a)
                                     for k_, a in st.items()}, chunk=16)
    with ctx.perf_options(ctx.PerfOptions(mlstm_bf16=True)):
        h, tst = port()
    assert h.dtype == torch.float32
    _close(h.numpy(), jh)
    for k_ in ("C", "n"):
        _close(tst[k_].numpy(), jst[k_], k_)
    h32, st32 = port()
    assert float((h - h32).abs().max()) > BF16_MOVES
    assert float((tst["C"] - st32["C"]).abs().max()) > BF16_MOVES


def test_forward_logits_match_jax_under_mlstm_bf16(params):
    """The reduced model's logits with ``mlstm_bf16`` on in both packages
    (S 512: two chunks of 256, so the carried state's bf16 products run),
    within MODEL_REL of JAX's (reading 1.6e-3), where the f32 core's
    logits are not (6.3e-3 from the port's)."""
    jcfg, cfg = _cfgs()
    tp = to_torch(params)
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (1, 512))
    with jctx.perf_options(jctx.PerfOptions(mlstm_bf16=True)):
        want = JX.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                          last_only=True)
    batch = {"tokens": torch.as_tensor(toks).long()}
    with ctx.perf_options(ctx.PerfOptions(mlstm_bf16=True)):
        got = get_model(cfg).forward(tp, batch, last_only=True)
    assert _rel(got.numpy(), want) <= MODEL_REL
    f32 = get_model(cfg).forward(tp, batch, last_only=True)
    # the f32 core's logits lie outside the tolerance the port meets
    assert _rel(f32.numpy(), want) > MODEL_REL


def test_mlstm_step_matches_jax_on_bf16_inputs():
    rs = np.random.RandomState(2)
    B, H, dh = 3, 2, 128
    q, k, v = (jnp.asarray(rs.standard_normal((B, H, dh)), jnp.bfloat16)
               for _ in range(3))
    il, fl = (a[:, 0] for a in _gates(rs, B, 1, H))
    st = {"C": rs.standard_normal((B, H, dh, dh)).astype(np.float32),
          "n": np.abs(rs.standard_normal((B, H, dh))).astype(np.float32)}
    jh, jst = JX.mlstm_step(q, k, v, jnp.asarray(il), jnp.asarray(fl),
                            {k_: jnp.asarray(a) for k_, a in st.items()})
    tq, tk, tv = (to_torch(np.asarray(a)) for a in (q, k, v))
    assert tq.dtype == torch.bfloat16
    h, tst = X.mlstm_step(tq, tk, tv, torch.as_tensor(il),
                          torch.as_tensor(fl),
                          {k_: torch.as_tensor(a) for k_, a in st.items()})
    assert h.dtype == tst["C"].dtype == torch.float32
    assert jh.dtype == jnp.float32
    assert _rel(h.float().numpy(), jh) <= 1e-5
    for k_ in ("C", "n"):
        assert _rel(tst[k_].numpy(), jst[k_]) <= 1e-5, k_


def test_slstm_apply_matches_jax_on_bf16(params):
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(lambda a: jnp.asarray(a[0], jnp.bfloat16),
                      params["groups"]["slstm"])
    tp = to_torch(jax.tree.map(np.asarray, jp))
    rs = np.random.RandomState(5)
    x = jnp.asarray(rs.standard_normal((2, 12, cfg.d_model)), jnp.bfloat16)
    jy, jst = JX.slstm_apply(jcfg, jp, x)
    y, st = X.slstm_apply(cfg, tp, to_torch(np.asarray(x)))
    assert y.dtype == torch.bfloat16
    assert _rel(y.float().numpy(), jy) <= 2.0 ** -6
    for k_ in ("h", "c", "n", "m"):
        assert st[k_].dtype == torch.float32
        assert _rel(st[k_].numpy(), jst[k_]) <= 2.0 ** -6, k_


def test_forward_logits_match_jax(params):
    jcfg, cfg = _cfgs()
    tp = to_torch(params)
    assert _flat(tp).keys() == _flat(params).keys()
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32))
    for last_only in (False, True):
        want = JX.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                          last_only=last_only)
        got = get_model(cfg).forward(
            tp, {"tokens": torch.as_tensor(toks).long()}, last_only=last_only)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= MODEL_REL, last_only


def test_prefill_states_and_three_decode_steps_match_jax(params):
    jcfg, cfg = _cfgs()
    tp = to_torch(params)
    jm, m = jax_get_model(jcfg), get_model(cfg)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (2, 16)).astype(np.int32)
    jlast, jst = jm.prefill(params, {"tokens": jnp.asarray(toks)}, 24)
    last, st = m.prefill(tp, {"tokens": torch.as_tensor(toks).long()}, 24)
    assert _rel(last.numpy(), jlast) <= MODEL_REL
    assert _flat(st).keys() == _flat(jst).keys()
    for k, v in _flat(st).items():
        assert tuple(v.shape) == _flat(jst)[k].shape, k
        assert _rel(v.float().numpy(), _flat(jst)[k]) <= MODEL_REL, k
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for t in range(3):
        jl, jst = jm.decode_step(params, jst, jnp.asarray(tok[:, None]),
                                 jnp.int32(16 + t))
        lg, st = m.decode_step(tp, st, torch.as_tensor(tok[:, None]).long(),
                               16 + t)
        assert _rel(lg.numpy(), jl) <= MODEL_REL, t
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for k, v in _flat(st).items():
        assert _rel(v.float().numpy(), _flat(jst)[k]) <= MODEL_REL, k


def test_generate_token_streams_match_jax():
    """One expert behind ``HashRouter(1)``: three 16-token prompts, 8 new
    tokens; ``core/coe.py``'s loop carries the state tree as it is."""
    jcfg, cfg = _cfgs()
    tree = _init(11)
    toks = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (3, 16)).astype(np.int32)
    cap = int(1.5 * sum(a.nbytes for a in jax.tree.leaves(tree)))
    jcoe = JaxCoE(JaxHashRouter(1), None, cap)
    coe = CompositionOfExperts(HashRouter(1), None, cap, device="cpu")
    jcoe.register(JaxHandle("m0", jcfg, tree))
    coe.register(ExpertHandle("m0", cfg, to_torch(tree)))
    try:
        want = jcoe.generate(toks, 8)
        got = coe.generate(toks, 8)
    finally:
        jcoe.cache.close()
        coe.cache.close()
    assert got.tokens.shape == (3, 8)
    assert (got.tokens == want.tokens).all()
    js, ps = jcoe.cache.stats, coe.cache.stats
    assert (ps.hits, ps.misses) == (js.hits, js.misses)


def test_chunk_rule_and_the_chunkwise_against_step_check(params):
    """S must be a multiple of min(256, S): 300 is refused by name; then
    ``chip_smoke.py``'s xLSTM checks at the reduced widths: each block of
    a prefill against f32 and each chunkwise core against its f64
    parallel form, the blocks of three decode steps teacher-forced, and the
    faults it plants (the core in bf16, the conv window and the sLSTM
    state not carried) caught."""
    _, cfg = _cfgs()
    q = torch.zeros((1, 300, 2, 16))
    g = torch.zeros((1, 300, 2))
    with pytest.raises(ValueError, match=r"multiple of min\(256, S\)"):
        X.mlstm_chunkwise(q, q, q, g, g)
    with pytest.raises(ValueError, match=r"multiple of min\(256, S\)"):
        get_model(cfg).forward(to_torch(params),
                               {"tokens": torch.zeros((1, 300),
                                                      dtype=torch.long)})
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # on f32 weights each block and its f32 reference are the same
    # computation; the f32 core and its f64 parallel form differ by rounding
    tp, model = to_torch(params), get_model(cfg)
    toks = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 16))).long()
    with smoke.xlstm_blocks_checked() as errs:
        last, st = model.prefill(tp, {"tokens": toks}, 20)
    assert [k for k, _, _ in errs] == (["core", "step", "mlstm"]
                                       + ["core", "mlstm"] * 2 + ["slstm"])
    blocks = ("mlstm", "slstm")
    assert all(u == 0.0 and s_ == 0.0 for k, u, s_ in errs if k in blocks)
    assert all(u <= 1e-4 and s_ <= 1e-4 for k, u, s_ in errs
               if k not in blocks)
    smoke.blocks_check("reduced", errs)
    x0 = tp["embed"]["tok"][toks]
    p0 = X._take(X._take(tp["groups"], 0)["mlstm"], 0)

    def bf16_core():
        with smoke.xlstm_blocks_checked(
                {"mlstm_chunkwise": smoke._chunkwise_autocast}) as errs:
            X.mlstm_block(cfg, p0, x0)
        smoke.blocks_check("reduced planted", errs)
    with torch.no_grad():
        smoke.expect_caught("reduced planted", bf16_core)
    # three decode steps teacher-forced: the step recurrence against the
    # chunkwise pass in f32
    _, fed, taps = smoke.xlstm_decode_tapped(model, tp, st, last.argmax(-1),
                                             16, 3)
    assert len(fed) == 3 and len(taps) == 12
    assert [r[3] is None for r in taps] == [False] * 4 + [True] * 8
    assert [r[5] is None for r in taps] == [True] * 8 + [False] * 4
    errs = smoke.xlstm_teacher_forced(cfg, taps, 3)
    assert max(max(u, s_) for _, u, s_ in errs) <= 1e-4, errs
    _, _, taps = smoke.xlstm_decode_tapped(model, tp, st, last.argmax(-1),
                                           16, 3, smoke.XLSTM_CARRY_FAULTS)
    errs = smoke.xlstm_teacher_forced(cfg, taps, 3)
    for kind in ("mlstm", "slstm"):
        smoke.expect_caught(kind, lambda: smoke.blocks_check(
            kind, [e for e in errs if e[0] == kind],
            tol=smoke.XLSTM_TF_TOL_REL))

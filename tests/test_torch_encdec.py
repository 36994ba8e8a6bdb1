"""The port's encoder-decoder family (Whisper-small's backbone) against the
JAX package on the CPU, at ``reduced(whisper-small)`` (2 encoder and 2
decoder layers, D 128, 4 heads of 32, 32 encoder frames). Both packages
get JAX's init through numpy (``bridge.to_torch``), every leaf moved by
seeded noise so that the zero-initialised biases and the unit LayerNorm
scales are exercised too, in bf16: JAX's encoder casts the frames to bf16
and its layer scan keeps the carry's type, so it runs on bf16 weights
only. The frame embeddings and the tokens come from a numpy seed.

Tolerances:
  * attention at Sq != Sk against JAX's ``naive_attention`` within 1e-5
    (f32, the same arithmetic in another order);
  * the sinusoids equal bit for bit;
  * bf16 (the encoder's output, logits, caches): within 3 % of the
    largest value (``BF16_REL``). The two frameworks round at different
    points (XLA's CPU backend keeps f32 through fused elementwise chains,
    PyTorch rounds each op); the reading is 0.5-1.2 %;
  * f32 (the decoder over JAX's encoder output, decode steps from JAX's
    prefill cache upcast): within atol 1e-4;
  * the port's decode steps against its own teacher-forced forward on f32
    weights within 1e-4 of the largest logit."""
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
from repro.models import encdec as JE
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models.common import ParamSpec as JaxSpec
from repro.models.common import param_bytes as jax_param_bytes
from repro_torch.bridge import to_torch
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import common, get_model
from repro_torch.models import encdec as E

ARCH = "whisper-small"
ATOL = 1e-4
LAYER_ATOL = 1e-5
BF16_REL = 0.03


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


@pytest.fixture(scope="module")
def params():
    """JAX's init moved by seeded noise, in bf16: JAX's encoder casts the
    frames to bf16 and its layer scan keeps the carry's type, so it runs
    only on bf16 weights."""
    jcfg, _ = _cfgs()
    tree = jax_get_model(jcfg).init(jax.random.PRNGKey(3))
    rs = np.random.RandomState(7)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float32) + 0.1 * rs.standard_normal(a.shape),
        jnp.bfloat16), tree)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(cfg, B=2, S=7, seed=0):
    rs = np.random.RandomState(seed)
    return {"enc_embeds": rs.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
            "tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {"enc_embeds": torch.as_tensor(batch["enc_embeds"]),
            "tokens": torch.as_tensor(batch["tokens"]).long()}


def _cache_f32(monkeypatch):
    """The port's cache in f32, for a case run on f32 weights."""
    spec = E.cache_spec
    monkeypatch.setattr(E, "cache_spec", lambda *a: {
        k: (sh, torch.float32) for k, (sh, _) in spec(*a).items()})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (it imports torch and
    numpy only; nothing runs on import)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
        assert "dec_layers/cross_attn/bv" in specs
        assert "dec_layers/cross_attn/bk" not in specs
        for k, s in specs.items():
            js = jspecs[k]
            assert (s.shape, s.axes, s.init, s.fan_in_axes) == \
                (js.shape, js.axes, js.init, js.fan_in_axes), (red, k)
            assert torch.empty((), dtype=s.dtype).element_size() == \
                np.dtype(js.dtype).itemsize, k
        cache = get_model(cfg).cache_spec(3, 40)
        jcache = jax_get_model(jcfg).cache_spec(3, 40)
        assert cache.keys() == jcache.keys()
        for k, (sh, dt) in cache.items():
            assert sh == jcache[k].shape and dt == torch.bfloat16, k
    # the whole backbone: 0.24 G parameters, 0.48 GB of bf16
    full = common.param_bytes(get_model(get_config(ARCH)).param_specs())
    assert full == jax_param_bytes(jax_get_model(
        jax_get_config(ARCH)).param_specs())
    assert 0.47e9 < full < 0.48e9


@pytest.mark.parametrize("shape", [(7, 32, 4, 4), (1, 45, 4, 2),
                                   (40, 17, 8, 2)])
def test_attention_at_sq_ne_sk_matches_jax(shape):
    """Cross-attention (not causal, no window): Sq queries over Sk keys, q
    heads on kv heads (G 1, 2, 4), against JAX's ``naive_attention`` and
    its ``L.attention`` (which takes the naive branch at these lengths)."""
    Sq, Sk, Hq, Hkv = shape
    rs = np.random.RandomState(Sq)
    q = rs.standard_normal((2, Sq, Hq, 32)).astype(np.float32)
    k = rs.standard_normal((2, Sk, Hkv, 32)).astype(np.float32)
    v = rs.standard_normal((2, Sk, Hkv, 32)).astype(np.float32)
    got = ops.attention(*map(torch.as_tensor, (q, k, v)), causal=False)
    assert got.shape == (2, Sq, Hq, 32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got.numpy(), JL.naive_attention(jq, jk, jv, causal=False),
           LAYER_ATOL)
    jcfg, _ = _cfgs()
    _close(got.numpy(), JL.attention(jcfg, jq, jk, jv, causal=False),
           LAYER_ATOL)


def test_attention_refuses_sq_ne_sk_when_causal_or_windowed(monkeypatch):
    """On the CPU, and on a tensor that reports a CUDA device before
    anything is built or launched."""

    class CudaLooking(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    def refuse(*a, **k):
        raise AssertionError("plain version or build reached")

    q = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    kv = torch.zeros((1, 9, 2, 32), dtype=torch.bfloat16)
    for kw in (dict(causal=True), dict(causal=False, window=4),
               dict(causal=True, window=4)):
        with pytest.raises(ValueError, match="9 keys for 4 queries"):
            ops.attention(q, kv, kv, **kw)
    monkeypatch.setattr(ops, "attention_ref", refuse)
    monkeypatch.setattr(rt, "bind", refuse)
    rt.reset_launches()
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="9 keys for 4 queries"):
            ops.attention(q.as_subclass(CudaLooking),
                          kv.as_subclass(CudaLooking),
                          kv.as_subclass(CudaLooking), **kw)
    assert rt.launch_counts()["flash_prefill"] == 0


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_encoder_and_forward_match_jax_in_bf16(params):
    jcfg, cfg = _cfgs()
    tp = to_torch(params)
    assert _flat(tp).keys() == _flat(params).keys()
    b = _batch(cfg)
    _close(E.sinusoid_pos(9, cfg.d_model).float().numpy(),
           JE.sinusoid_pos(9, cfg.d_model), 0)
    pos = np.array([5])
    _close(E.sinusoid_pos(pos, cfg.d_model).float().numpy(),
           JE.sinusoid_pos(jnp.asarray(pos), cfg.d_model), 0)
    got = E.encode(cfg, tp, torch.as_tensor(b["enc_embeds"]))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), JE.encode(
        jcfg, params, jnp.asarray(b["enc_embeds"]))) <= BF16_REL
    for last_only in (False, True):
        want = JE.forward(jcfg, params, _jax(b), last_only=last_only)
        got = get_model(cfg).forward(tp, _torch(b), last_only=last_only)
        assert got.shape == want.shape
        assert _rel(got.float().numpy(), want) <= BF16_REL, last_only


def test_decoder_and_its_caches_match_jax_in_f32(params):
    """The decoder on f32 weights over JAX's encoder output (bf16, upcast):
    its logits and each layer's self and cross K/V."""
    jcfg, cfg = _cfgs()
    p32 = _f32(params)
    b = _batch(cfg, S=6, seed=4)
    enc = np.asarray(JE.encode(jcfg, params, jnp.asarray(b["enc_embeds"])),
                     np.float32)
    jl, (jk, jv, jkc, jvc) = JE._decoder(jcfg, p32, jnp.asarray(b["tokens"]),
                                         jnp.asarray(enc), return_cache=True)
    cache = {k: torch.zeros(sh, dtype=torch.float32)
             for k, (sh, _) in E.cache_spec(cfg, 2, 6).items()}
    got = E._decoder(cfg, to_torch(p32), torch.as_tensor(b["tokens"]).long(),
                     torch.as_tensor(enc), cache=cache)
    _close(got.numpy(), jl)
    for k, w in zip(("k", "v", "cross_k", "cross_v"), (jk, jv, jkc, jvc)):
        _close(cache[k].numpy(), w, msg=k)


def test_prefill_and_three_decode_steps_match_jax(params):
    """A bf16 prefill and 3 bf16 steps (each step's logits and the final
    cache within ``BF16_REL``); then the 3 steps again on f32 weights from
    JAX's prefill cache upcast (within ``ATOL``)."""
    jcfg, cfg = _cfgs()
    tp = to_torch(params)
    b = _batch(cfg, S=5, seed=1)
    jm, m = jax_get_model(jcfg), get_model(cfg)
    jlast, jc = jm.prefill(params, _jax(b), 12)
    last, c = m.prefill(tp, _torch(b), 12)
    assert _rel(last.float().numpy(), jlast) <= BF16_REL
    assert c.keys() == jc.keys()
    for k in c:
        assert tuple(c[k].shape) == jc[k].shape, k
        assert c[k].dtype == torch.bfloat16, k
        assert _rel(c[k].float().numpy(), jc[k]) <= BF16_REL, k
    assert not c["k"][:, :, 5:].any()
    j32 = {k: jnp.asarray(v, jnp.float32) for k, v in jc.items()}
    c32 = {k: torch.as_tensor(np.asarray(v, np.float32)).clone()
           for k, v in jc.items()}
    p32 = _f32(params)
    tp32 = to_torch(p32)
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (3, 2))
    for t in range(3):
        tok = toks[t][:, None].astype(np.int32)
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok), jnp.int32(5 + t))
        lg, c = m.decode_step(tp, c, torch.as_tensor(tok).long(), 5 + t)
        assert _rel(lg.float().numpy(), jl) <= BF16_REL, t
        jl, j32 = jm.decode_step(p32, j32, jnp.asarray(tok), jnp.int32(5 + t))
        lg, c32 = m.decode_step(tp32, c32, torch.as_tensor(tok).long(), 5 + t)
        _close(lg.numpy(), jl, msg=f"f32 step {t}")
    for k in c:
        assert _rel(c[k].float().numpy(), jc[k]) <= BF16_REL, k
        _close(c32[k].numpy(), j32[k], msg=k)


def test_decode_steps_match_the_teacher_forced_forward(params, monkeypatch):
    """``chip_smoke.py``'s Whisper check at the reduced size, in f32: a
    prefill of 4 tokens and 5 greedy steps against the forward over the
    prompt and the tokens fed back, position by position; then each
    attention of a prefill at the model's inputs against the plain
    version (exact here, where the wrapper is the plain version) and the
    cross-attention's keys cut at a tile edge (the card's planted fault)
    above the card's limit."""
    _cache_f32(monkeypatch)
    _, cfg = _cfgs()
    tp = to_torch(_f32(params))
    b = _torch(_batch(cfg, S=4, seed=3))
    smoke = _chip_smoke()
    steps, toks = smoke.whisper_greedy(get_model(cfg), tp, b, 6)
    assert toks.shape == (2, 6)
    full = get_model(cfg).forward(tp, {"enc_embeds": b["enc_embeds"],
                                       "tokens": torch.cat(
                                           [b["tokens"], toks[:, :-1]], 1)})
    want = full[:, 3:]
    err = float((steps - want).abs().max())
    assert err <= ATOL * float(want.abs().max()), err
    with smoke.attention_checked() as errs:
        get_model(cfg).prefill(tp, b, 8)
    assert len(errs) == cfg.n_encoder_layers + 2 * cfg.n_layers
    assert max(errs) == 0.0, errs
    with smoke.cross_tail_planted(cfg.encoder_seq - 8), \
            smoke.attention_checked() as errs:
        get_model(cfg).prefill(tp, b, 8)
    cross = errs[cfg.n_encoder_layers + 1::2]
    assert min(cross) > smoke.PREFILL_ROW_REL_L2, errs

"""The dense-cache decode path of the port against the JAX package, on the
CPU, on the same numpy inputs:

  * the plain versions of the three kernels of ``decoder_layer_step``
    (``qkv_rope``, ``decode``, ``ffn_swiglu``) against the Pallas kernels
    run in interpret mode, at f32 within ATOL = 1e-5 (the two frameworks sum
    in different orders; the RoPE frequencies come from numpy in float64 in
    the port and from f32 ``exp(-log(theta) * 2i/rot)`` in the kernel, which
    differ in the last f32 bits, times positions below 20);
  * ``decoder_layer_step`` against JAX's, for y and both caches;
  * the model's ``prefill`` + ``decode_step`` on the reduced
    samba-coe-expert-7b at f32 weights, for logits and caches;
  * the L-layer composition of ``decoder_layer_step`` through
    ``layer_step_params`` against the port's own ``decode_step``.

On CPU tensors the kernel wrappers run their plain versions and launch
nothing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention.ops import decode as jax_decode
from repro.kernels.fused_decode.kernel import ffn_swiglu as jax_ffn_swiglu
from repro.kernels.fused_decode.kernel import qkv_rope as jax_qkv_rope
from repro.kernels.fused_decode.ops import \
    decoder_layer_step as jax_decoder_layer_step
from repro.models import get_model as jax_get_model
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import decode
from repro_torch.kernels.fused_decode.ops import (decoder_layer_step,
                                                  ffn_swiglu,
                                                  layer_step_params, qkv_rope)
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATOL = 1e-5          # kernels and one layer, f32
MODEL_ATOL = 1e-4    # logits after the reduced model's 4 layers, f32
BIG = 1.0e4          # cache fill past ``length``: a read would show


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _n(rs, shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_qkv_rope_plain_matches_pallas():
    """GQA and partial rotation: (n_q, n_kv, rope_frac) with v unrotated."""
    B, D, dh, pos = 3, 128, 32, 17
    rt.reset_launches()
    for n_q, n_kv, frac in ((4, 4, 1.0), (4, 2, 1.0), (8, 2, 0.5),
                            (4, 1, 0.5)):
        rs = np.random.RandomState(n_q + n_kv)
        H = n_q + 2 * n_kv
        x, scale = _n(rs, (B, D)), _n(rs, (D,))
        w = _n(rs, (D, H * dh), 0.05)
        kw = dict(n_q=n_q, n_kv=n_kv, dh=dh, theta=10000.0, rope_frac=frac)
        want = jax_qkv_rope(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(w), pos, interpret=True, **kw)
        got = qkv_rope(*map(torch.as_tensor, (x, scale, w)), pos, **kw)
        assert got.shape == (H, B, dh)
        _close(got, want)
        if frac < 1:       # the unrotated tail really passes through
            rot = int(dh * frac)
            y = (L.rms_norm(torch.as_tensor(x), torch.as_tensor(scale))
                 @ torch.as_tensor(w)).reshape(B, H, dh).transpose(0, 1)
            _close(got[:n_q + n_kv, :, rot:], y[:n_q + n_kv, :, rot:])
            _close(got[n_q + n_kv:], y[n_q + n_kv:])
    assert rt.launch_counts()["qkv_rope"] == 0


def test_decode_plain_matches_pallas_and_never_reads_past_length():
    B, S, dh = 3, 24, 32
    for hq, hkv in ((4, 4), (4, 2), (8, 2)):         # G = 1, 2, 4
        rs = np.random.RandomState(hq * hkv)
        q = _n(rs, (B, hq, dh))
        kc, vc = _n(rs, (B, S, hkv, dh)), _n(rs, (B, S, hkv, dh))
        for length in (1, 9, S):
            k2, v2 = kc.copy(), vc.copy()
            k2[:, length:], v2[:, length:] = BIG, BIG
            want = jax_decode(*map(jnp.asarray, (q, k2, v2)), length,
                              interpret=True)
            got = decode(*map(torch.as_tensor, (q, k2, v2)), length)
            assert torch.isfinite(got).all()
            _close(got, want)
            # the same as a cache cut at ``length``
            cut = decode(*map(torch.as_tensor, (q, kc[:, :length],
                                                vc[:, :length])), length)
            _close(got, cut, atol=1e-6)
    with pytest.raises(ValueError, match="no position"):
        decode(*map(torch.as_tensor, (q, kc, vc)), 0)


def test_ffn_swiglu_plain_matches_pallas_both_forms():
    B, D, F = 4, 128, 256
    rs = np.random.RandomState(3)
    args = (_n(rs, (B, D)), _n(rs, (D,)), _n(rs, (D, F), 0.05),
            _n(rs, (D, F), 0.05), _n(rs, (F, D), 0.05))
    for residual in (True, False):
        want = jax_ffn_swiglu(*map(jnp.asarray, args), block_f=64,
                              residual=residual, interpret=True)
        got = ffn_swiglu(*map(torch.as_tensor, args), residual=residual)
        _close(got, want)
    # the partial form is the full one less its residual
    full = ffn_swiglu(*map(torch.as_tensor, args))
    part = ffn_swiglu(*map(torch.as_tensor, args), residual=False)
    _close(full - torch.as_tensor(args[0]), part)


def _layer_inputs(rs, B, S, D, n_q, n_kv, dh, F, pos):
    p = {"attn_norm": 1 + _n(rs, (D,), 0.1),
         "w_qkv": _n(rs, (D, (n_q + 2 * n_kv) * dh), D ** -0.5),
         "w_o": _n(rs, (n_q * dh, D), (n_q * dh) ** -0.5),
         "mlp_norm": 1 + _n(rs, (D,), 0.1),
         "w_gate": _n(rs, (D, F), D ** -0.5),
         "w_up": _n(rs, (D, F), D ** -0.5),
         "w_down": _n(rs, (F, D), F ** -0.5)}
    kc, vc = _n(rs, (B, S, n_kv, dh)), _n(rs, (B, S, n_kv, dh))
    kc[:, pos + 1:], vc[:, pos + 1:] = BIG, BIG
    return _n(rs, (B, D)), p, kc, vc


def test_decoder_layer_step_matches_jax():
    B, S, D, n_q, n_kv, dh, F, pos = 3, 16, 128, 4, 2, 32, 256, 6
    x, p, kc, vc = _layer_inputs(np.random.RandomState(5), B, S, D, n_q,
                                 n_kv, dh, F, pos)
    kw = dict(n_q=n_q, n_kv=n_kv, dh=dh, theta=10000.0)
    jy, jk, jv = jax_decoder_layer_step(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(kc), jnp.asarray(vc), jnp.int32(pos), interpret=True,
        **kw)
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    y, k2, v2 = decoder_layer_step(torch.as_tensor(x),
                                   {k: torch.as_tensor(v)
                                    for k, v in p.items()},
                                   tk, tv, pos, **kw)
    assert k2 is tk and v2 is tv                 # written in place
    _close(y, jy, MODEL_ATOL)
    _close(k2, jk)
    _close(v2, jv)
    # only position ``pos`` of the caches changed
    assert np.array_equal(np.delete(k2.numpy(), pos, axis=1),
                          np.delete(kc, pos, axis=1))


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    p = jax_get_model(jcfg).init(jax.random.PRNGKey(3))
    return (jcfg, reduced(get_config("samba-coe-expert-7b")),
            jax.tree.map(lambda a: np.asarray(a, np.float32), p))


def test_prefill_and_decode_step_match_jax(model):
    """The JAX cache is bf16 whatever the weights, and JAX's decode_step
    refuses an f32 token into it, so the decode step runs both packages on
    the same f32 copy of the prefilled cache."""
    jcfg, cfg, tree = model
    B, S, max_len = 2, 7, 12
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    jm, m = jax_get_model(jcfg), get_model(cfg)
    params = to_torch(tree)
    jlast, jcache = jm.prefill(tree, {"tokens": jnp.asarray(toks)}, max_len)
    last, cache = m.prefill(params, {"tokens": torch.as_tensor(toks)},
                            max_len)
    assert cache["k"].shape == jcache["k"].shape == \
        (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    assert cache["k"].dtype == torch.bfloat16
    _close(last, jlast, MODEL_ATOL)
    for name in ("k", "v"):
        # f32 K/V a few f32 ulps apart may round to neighbouring bf16
        # values: one bf16 unit (2^-7 relative) apart at most
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   rtol=2.0 ** -7, atol=1e-6)
        assert not cache[name][:, :, S:].any()

    c32 = {k: np.asarray(v, np.float32) for k, v in jcache.items()}
    tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
    jlg, jc2 = jm.decode_step(tree, {k: jnp.asarray(v) for k, v in
                                     c32.items()}, jnp.asarray(tok),
                              jnp.int32(S))
    tc = {k: torch.as_tensor(v.copy()) for k, v in c32.items()}
    lg, c2 = m.decode_step(params, tc, torch.as_tensor(tok), S)
    assert c2["k"] is tc["k"]
    _close(lg, jlg, MODEL_ATOL)
    for name in ("k", "v"):
        _close(c2[name], jc2[name])


def test_layer_step_composition_matches_decode_step(model):
    """32 decoder_layer_steps plus embedding, final norm and unembedding
    are the model's decode step: here its reduced 4 layers, two steps."""
    _, cfg, tree = model
    params = to_torch(tree)
    B, S, max_len = 3, 5, 9
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)))
    _, cache = T.prefill(cfg, params, toks, max_len)
    ref = {k: v.float() for k, v in cache.items()}
    fused = {k: v.float() for k, v in cache.items()}
    steps = [layer_step_params(params, i) for i in range(cfg.n_layers)]
    assert steps[0]["w_qkv"].shape == (
        cfg.d_model, (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim)
    rt.reset_launches()
    tok = toks[:, -1:]
    for pos in (S, S + 1):
        want, _ = T.decode_step(cfg, params, ref, tok, pos)
        h = T.embed_tokens(cfg, params, tok[:, 0])
        for i, p in enumerate(steps):
            h, _, _ = decoder_layer_step(
                h, p, fused["k"][i], fused["v"][i], pos, n_q=cfg.n_heads,
                n_kv=cfg.n_kv_heads, dh=cfg.head_dim, theta=cfg.rope_theta)
        got = T.unembed(cfg, params, L.apply_norm(cfg, params["final_norm"],
                                                  h))
        _close(got, want)
        for name in ("k", "v"):
            _close(fused[name], ref[name])
        tok = want.argmax(-1)[:, None]
    assert rt.launch_counts() == {k: 0 for k in rt.launch_counts()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.cache_spec(dataclasses.replace(cfg, sliding_window=4), 1, 8)

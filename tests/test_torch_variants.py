"""The dense-family variants of the port against the JAX package, on the
CPU, at ``reduced(...)`` size: granite-8b (GQA, full RoPE), qwen2.5-32b
(QKV biases), chatglm3-6b (QKV biases, partial RoPE), starcoder2-3b
(LayerNorm, GELU MLP, QKV / output / MLP biases, tied embeddings) and
qwen2-vl-2b (m-RoPE, QKV biases, tied embeddings, ``patch_embeds``).

Both packages get the same f32 weights: JAX's init, handed over through
numpy, with every bias and norm leaf (zeros and ones at init) redrawn from
a seed so that the bias branches carry weight. Each case loops over the
five configs:

  * configs, parameter specs and bytes equal JAX's; ``bridge`` carries
    JAX's trees, without ``lm_head`` where tied, leaf for leaf;
  * forward logits and per-layer K/V within atol 1e-4 (f32; the two
    frameworks sum in other orders), also with qwen2-vl's patch embeds;
  * ``prefill`` and 3 ``decode_step``s against JAX's within the same atol
    (JAX's dense cache is bf16 whatever the weights and its decode refuses
    an f32 token into it, so both decode from the same f32 copy of the
    prefilled cache, as ``test_torch_dense_decode.py`` does);
  * ``layer_norm``, partial RoPE, m-RoPE (2-D and 3-D positions) and the
    GELU / SwiGLU FFN with biases against JAX's functions within 1e-5;
  * ``qkv_rope_paged``'s plain version at ``rope_frac`` 0.5 against JAX's
    Pallas kernel in interpret mode, and its wrapper on CPU tensors."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.fused_decode.kernel import \
    qkv_rope_paged as jax_qkv_rope_paged
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models.common import ParamSpec as JaxSpec
from repro.models.common import param_bytes as jax_param_bytes
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.fused_decode.ops import qkv_rope_paged
from repro_torch.kernels.fused_decode.ref import (qkv_rope_paged_ref,
                                                  rope_inv_freq)
from repro_torch.models import common, get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ("granite-8b", "qwen2.5-32b", "chatglm3-6b", "starcoder2-3b",
         "qwen2-vl-2b")
ATOL = 1e-4
LAYER_ATOL = 1e-5
BIAS_LEAVES = {"bq", "bk", "bv", "bo", "bi", "bi_gate", "bi_up", "bias"}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return jax_reduced(jax_get_config(arch)), reduced(get_config(arch))


def _tree(jcfg, seed):
    """JAX's f32 init of ``jcfg`` with the bias and norm leaves redrawn."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        key = str(path[-1].key)
        if key in BIAS_LEAVES:
            return (0.1 * rs.standard_normal(a.shape)).astype(np.float32)
        if key == "scale":
            return (1 + 0.1 * rs.standard_normal(a.shape)).astype(np.float32)
        return a
    p = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(draw, p)


@pytest.fixture(scope="module")
def trees():
    return {arch: _tree(_cfgs(arch)[0], i) for i, arch in enumerate(ARCHS)}


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def test_configs_specs_and_bridge_match_jax(trees):
    fields = [f.name for f in dataclasses.fields(CONFIGS["granite-8b"])]
    for arch in ARCHS:
        for red in (False, True):
            jcfg, cfg = _cfgs(arch) if red else (jax_get_config(arch),
                                                 get_config(arch))
            for f in fields:
                assert getattr(cfg, f) == getattr(jcfg, f), (arch, red, f)
            specs = _flat(get_model(cfg).param_specs())
            jspecs = {"/".join(str(p.key) for p in path): s
                      for path, s in jax.tree_util.tree_flatten_with_path(
                          jax_get_model(jcfg).param_specs(),
                          is_leaf=lambda x: isinstance(x, JaxSpec))[0]}
            assert specs.keys() == jspecs.keys(), arch
            for k, s in specs.items():
                js = jspecs[k]
                assert (s.shape, s.axes, s.init, s.fan_in_axes) == \
                    (js.shape, js.axes, js.init, js.fan_in_axes), (arch, k)
            assert common.param_bytes(get_model(cfg).param_specs()) == \
                jax_param_bytes(jax_get_model(jcfg).param_specs()), arch
        assert ("lm_head" in specs) == (not cfg.tie_embeddings), arch
        # init makes every leaf, zeros for the biases; the bridge carries
        # JAX's tree into the same keys and shapes and back, bit for bit
        p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        got = _flat(to_torch(trees[arch]))
        assert got.keys() == _flat(p).keys(), arch
        for k, t in _flat(p).items():
            assert got[k].shape == t.shape, (arch, k)
            if k.split("/")[-1] in BIAS_LEAVES:
                assert not t.any(), (arch, k)
        back = _flat(to_numpy(to_torch(trees[arch])))
        for k, a in _flat(trees[arch]).items():
            np.testing.assert_array_equal(back[k], a, err_msg=k)


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_and_cache_match_jax(trees, last_only):
    rs = np.random.RandomState(0)
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        tokens = rs.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        jl, jc = _jax_forward(jcfg, trees[arch], tokens, last_only)
        tl, tc = T.forward(cfg, to_torch(trees[arch]),
                           {"tokens": torch.as_tensor(tokens).long()},
                           return_cache=True, last_only=last_only)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=arch)
        for t, j in zip(tc[0], jc[0]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                       rtol=0, err_msg=arch)


def _jax_forward(jcfg, tree, tokens, last_only, **batch):
    from repro.models import transformer as JT
    return JT.forward(jcfg, tree, {"tokens": jnp.asarray(tokens), **batch},
                      return_cache=True, last_only=last_only)


def test_patch_embeds_forward_matches_jax(trees):
    """qwen2-vl's vision stub: patch embeds replace the prompt's first P
    embeddings (JAX ``tests/test_arch_smoke.py``'s VLM case)."""
    jcfg, cfg = _cfgs("qwen2-vl-2b")
    rs = np.random.RandomState(3)
    tokens = rs.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    pe = rs.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    jl, _ = _jax_forward(jcfg, trees["qwen2-vl-2b"], tokens, False,
                         patch_embeds=jnp.asarray(pe))
    tl = T.forward(cfg, to_torch(trees["qwen2-vl-2b"]),
                   {"tokens": torch.as_tensor(tokens).long(),
                    "patch_embeds": torch.as_tensor(pe)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    plain = T.forward(cfg, to_torch(trees["qwen2-vl-2b"]),
                      {"tokens": torch.as_tensor(tokens).long()})
    assert not torch.allclose(tl, plain, atol=1e-3)  # the embeds took part


def test_prefill_and_decode_steps_match_jax(trees):
    B, S, max_len, steps = 2, 7, 12, 3
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        tree = trees[arch]
        toks = np.random.RandomState(1).randint(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        jm, m = jax_get_model(jcfg), get_model(cfg)
        params = to_torch(tree)
        jlast, jcache = jm.prefill(tree, {"tokens": jnp.asarray(toks)},
                                   max_len)
        last, cache = m.prefill(params, {"tokens": torch.as_tensor(toks)},
                                max_len)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   atol=ATOL, rtol=0, err_msg=arch)
        for name in ("k", "v"):
            # f32 K/V a few ulps apart may round to neighbouring bf16
            # values: one bf16 unit (2^-7 relative) apart at most
            np.testing.assert_allclose(
                cache[name].float().numpy(),
                np.asarray(jcache[name], np.float32), rtol=2.0 ** -7,
                atol=1e-6, err_msg=arch)
        jc = {k: jnp.asarray(np.asarray(v, np.float32))
              for k, v in jcache.items()}
        tc = {k: torch.as_tensor(np.asarray(v, np.float32).copy())
              for k, v in jcache.items()}
        tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
        for t in range(steps):
            jlg, jc = jm.decode_step(tree, jc, jnp.asarray(tok),
                                     jnp.int32(S + t))
            lg, tc = m.decode_step(params, tc, torch.as_tensor(tok), S + t)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{arch} step {t}")
            for name in ("k", "v"):
                np.testing.assert_allclose(tc[name].numpy(),
                                           np.asarray(jc[name]), atol=ATOL,
                                           rtol=0, err_msg=arch)
            tok = np.array(jnp.argmax(jlg, -1), np.int32)[:, None]


def test_layers_match_jax():
    rs = np.random.RandomState(2)
    h = rs.standard_normal((3, 5, 128)).astype(np.float32) * 3 + 1
    sc, b = rs.standard_normal((2, 128)).astype(np.float32)
    np.testing.assert_allclose(
        L.layer_norm(*map(torch.as_tensor, (h, sc, b))).numpy(),
        np.asarray(JL.layer_norm(*map(jnp.asarray, (h, sc, b)))),
        atol=LAYER_ATOL, rtol=0)
    x = rs.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rs.randint(0, 300, (2, 5)).astype(np.int32)
    pos3 = rs.randint(0, 300, (3, 2, 5)).astype(np.int32)
    for arch in ("chatglm3-6b", "qwen2-vl-2b"):
        jcfg, cfg = _cfgs(arch)
        for p in ((pos, pos3) if cfg.rope_style == "mrope" else (pos,)):
            got = L.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(p))
            np.testing.assert_allclose(
                got.numpy(), np.asarray(JL.apply_rope(jcfg, jnp.asarray(x),
                                                      jnp.asarray(p))),
                atol=LAYER_ATOL, rtol=0, err_msg=f"{arch} {p.shape}")
    # partial RoPE leaves the unrotated half as it was
    _, glm = _cfgs("chatglm3-6b")
    got = L.apply_rope(glm, torch.as_tensor(x), torch.as_tensor(pos))
    np.testing.assert_array_equal(got[..., 16:].numpy(), x[..., 16:])
    for arch in ("starcoder2-3b", "qwen2.5-32b"):
        for bias in (True, False):
            jcfg, cfg = (dataclasses.replace(c, mlp_bias=bias)
                         for c in _cfgs(arch))
            tree = _tree(dataclasses.replace(jcfg, n_layers=1), 5)
            mp = jax.tree.map(lambda a: a[0], tree["layers"]["mlp"])
            xs = rs.standard_normal((2, 3, 128)).astype(np.float32)
            np.testing.assert_allclose(
                L.ffn_apply(cfg, to_torch(mp), torch.as_tensor(xs)).numpy(),
                np.asarray(JL.ffn_apply(jcfg, mp, jnp.asarray(xs))),
                atol=LAYER_ATOL, rtol=0, err_msg=f"{arch} bias={bias}")


def test_qkv_rope_paged_rope_frac_matches_pallas():
    """The plain version at rope_frac 0.5 (chatglm3's partial rotation)
    against JAX's Pallas kernel in interpret mode; the wrapper on CPU tensors
    runs it and launches nothing."""
    B, D, n_q, n_kv, dh = 4, 128, 4, 2, 32
    rs = np.random.RandomState(1)
    x = rs.standard_normal((B, D)).astype(np.float32)
    scale = rs.standard_normal((D,)).astype(np.float32)
    wq = (rs.standard_normal((D, n_q, dh)) * 0.05).astype(np.float32)
    wk = (rs.standard_normal((D, n_kv, dh)) * 0.05).astype(np.float32)
    wv = (rs.standard_normal((D, n_kv, dh)) * 0.05).astype(np.float32)
    pos = np.asarray([0, 3, 17, 100], np.int32)
    args = (x, scale, wq, wk, wv, pos)
    rt.reset_launches()
    for frac in (0.5, 1.0):
        want = jax_qkv_rope_paged(*map(jnp.asarray, args), theta=10000.0,
                                  rope_frac=frac, interpret=True)
        inv = torch.as_tensor(rope_inv_freq(dh, 10000.0, frac))
        t = [torch.as_tensor(a) for a in args]
        for got in (qkv_rope_paged_ref(*t, inv),
                    qkv_rope_paged(*t, theta=10000.0, rope_frac=frac)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=LAYER_ATOL, rtol=0,
                                           err_msg=str(frac))
    # the rows past the rotated half of q and k, and all of v, unrotated
    half = qkv_rope_paged(*map(torch.as_tensor, args), rope_frac=0.5)
    zero = qkv_rope_paged_ref(*map(torch.as_tensor, args[:5]),
                              torch.zeros(B, dtype=torch.int32),
                              torch.as_tensor(rope_inv_freq(dh, 1e4, 0.5)))
    for g, z in zip(half, zero):
        np.testing.assert_allclose(g[..., dh // 2:].numpy(),
                                   z[..., dh // 2:].numpy(), atol=1e-6)
    assert not any(rt.launch_counts().values())

"""The port's dense model against the JAX package on the reduced
samba-coe-expert-7b: both packages get the same f32 weights and tokens
(through numpy), and the logits and per-layer K/V caches agree within
atol 1e-4 (f32; the two frameworks sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.common import param_bytes as jax_param_bytes
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.models import common, get_model, layers as L, transformer as T

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cfgs():
    return (jax_reduced(jax_get_config("samba-coe-expert-7b")),
            reduced(get_config("samba-coe-expert-7b")))


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, _ = cfgs
    p = jax_get_model(jcfg).init(jax.random.PRNGKey(1))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), p)


def test_reduced_config_matches_jax(cfgs):
    jcfg, cfg = cfgs
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "rope_theta", "name"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full_j, full = jax_get_config("samba-coe-expert-7b"), \
        get_config("samba-coe-expert-7b")
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size) == \
        (full_j.n_layers, full_j.d_model, full_j.d_ff, full_j.vocab_size)


def test_param_bytes_match_jax(cfgs):
    jcfg, cfg = cfgs
    assert common.param_bytes(get_model(cfg).param_specs()) == \
        jax_param_bytes(jax_get_model(jcfg).param_specs())


def test_init_rule_normal_over_sqrt_fan_in(cfgs):
    _, cfg = cfgs
    gen = torch.Generator().manual_seed(0)
    p = get_model(cfg).init(gen, "cpu")
    assert torch.all(p["final_norm"]["scale"] == 1)
    # fan_in: every axis but the last of the unstacked spec, as in JAX
    wq = p["layers"]["attn"]["wq"].float()       # fan_in = D * Hq
    assert abs(wq.std().item() * np.sqrt(cfg.d_model * cfg.n_heads) - 1) < 0.05
    wo = p["layers"]["attn"]["wo"].float()       # fan_in = Hq * dh
    assert abs(wo.std().item() * np.sqrt(cfg.n_heads * cfg.head_dim) - 1) < 0.05
    gen2 = torch.Generator().manual_seed(0)
    again = get_model(cfg).init(gen2, "cpu")
    assert torch.equal(again["lm_head"], p["lm_head"])


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_and_cache_match_jax(cfgs, params, last_only):
    jcfg, cfg = cfgs
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                        return_cache=True, last_only=last_only)
    tl, tc = T.forward(cfg, to_torch(params),
                       {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
                       return_cache=True, last_only=last_only)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    (jk, jv), (tk, tv) = jc[0], tc[0]
    assert tuple(tk.shape) == jk.shape
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_layers_match_jax(cfgs):
    jcfg, cfg = cfgs
    rs = np.random.RandomState(2)
    x = rs.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rs.randint(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(pos)).numpy(),
        np.asarray(JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5, rtol=0)
    h = rs.standard_normal((3, 128)).astype(np.float32)
    sc = rs.standard_normal((128,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_norm(torch.as_tensor(h), torch.as_tensor(sc)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(h), jnp.asarray(sc))),
        atol=1e-5, rtol=0)
    q = rs.standard_normal((2, 6, 4, 32)).astype(np.float32)
    k = rs.standard_normal((2, 6, 2, 32)).astype(np.float32)
    v = rs.standard_normal((2, 6, 2, 32)).astype(np.float32)
    np.testing.assert_allclose(
        L.naive_attention(*map(torch.as_tensor, (q, k, v))).numpy(),
        np.asarray(JL.naive_attention(*map(jnp.asarray, (q, k, v)))),
        atol=1e-5, rtol=0)


def test_other_families_raise_naming_roadmap(cfgs):
    import dataclasses
    _, cfg = cfgs
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(dataclasses.replace(cfg, family="moe"))

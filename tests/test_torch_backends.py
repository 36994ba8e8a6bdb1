"""The port's paged extend step against the JAX package's, on the same f32
weights, pools, tables and tokens (2 layers, so interpret mode stays fast):
the port's fused body (on CPU tensors: the kernels' plain versions) against
JAX ``fused_paged_extend(interpret=True)``, and the port's reference body
against JAX ``xla_paged_extend``. Logits and the scattered pools agree
within atol 1e-4 (f32, different summation orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro.serving import backends as JB
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.serving import backends as B

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n_kv, seed=5):
    jcfg = dataclasses.replace(
        jax_reduced(jax_get_config("samba-coe-expert-7b")), n_layers=2,
        n_kv_heads=n_kv)
    cfg = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                              n_layers=2, n_kv_heads=n_kv)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jax_get_model(jcfg).init(jax.random.PRNGKey(seed)))
    Bn, block, maxb = 4, 8, 3
    rows = Bn * maxb + 1
    rs = np.random.RandomState(6)
    shape = (cfg.n_layers, rows, block, n_kv, cfg.head_dim)
    pk = (rs.standard_normal(shape) * 0.1).astype(np.float32)
    pv = (rs.standard_normal(shape) * 0.1).astype(np.float32)
    tables = rs.permutation(rows - 1)[:Bn * maxb].reshape(Bn, maxb) \
        .astype(np.int32)
    lengths = np.asarray([0, 7, 8, 15], np.int32)      # ragged + straddling
    active = np.asarray([True, True, False, True])
    tokens = rs.randint(0, cfg.vocab_size, (Bn, 1)).astype(np.int32)
    return jcfg, cfg, params, (pk, pv, tables, lengths, active, tokens), \
        rows - 1


def _run_port(fn, cfg, params, arrays, scratch):
    pk, pv, tables, lengths, active, tokens = arrays
    return fn(cfg, to_torch(params), torch.tensor(pk), torch.tensor(pv),
              torch.as_tensor(tables), torch.as_tensor(lengths),
              torch.as_tensor(active), torch.as_tensor(tokens, dtype=torch.long),
              scratch)


def _close(port, jax_out):
    for a, b in zip(port, jax_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_kv", [4, 2])
def test_fused_extend_matches_jax_fused_interpret(n_kv):
    jcfg, cfg, params, arrays, scratch = _case(n_kv)
    want = JB.fused_paged_extend(jcfg, params,
                                 *map(jnp.asarray, arrays), scratch,
                                 interpret=True)
    got = _run_port(B.fused_paged_extend, cfg, params, arrays, scratch)
    _close(got, want)
    # the inactive lane's own blocks are untouched; only scratch absorbed it
    pk0 = arrays[0]
    for row in arrays[2][2]:
        np.testing.assert_array_equal(got[1][:, row].numpy(), pk0[:, row])


@pytest.mark.parametrize("n_kv", [4, 1])
def test_reference_extend_matches_jax_xla_body(n_kv):
    jcfg, cfg, params, arrays, scratch = _case(n_kv)
    want = JB.xla_paged_extend(jcfg, params, *map(jnp.asarray, arrays),
                               scratch)
    got = _run_port(B.xla_paged_extend, cfg, params, arrays, scratch)
    _close(got, want)
    fused = _run_port(B.fused_paged_extend, cfg, params, arrays, scratch)
    _close(fused, [t.numpy() for t in got])


def test_hbm_bytes_at_7b_width():
    cfg = get_config("samba-coe-expert-7b")
    len1 = [256] * 8
    per = B.kernel_hbm_bytes(cfg, 8, len1, maxb=32)
    D, F, H, dh = 4096, 11008, 96, 128
    # weights dominate: 100.7 MB (qkv) and 304.1 MB (epilogue) in bf16
    assert per["qkv_rope_paged"] - D * H * dh * 2 < 2e6
    assert per["oproj_ffn_swiglu"] - (4096 * D + 3 * D * F) * 2 < 2e6
    # K/V by each lane's len1: 16 KiB per token per layer at this width
    kv = per["decode_paged"] - 2 * 8 * 32 * dh * 2 - 8 * 32 * 4 - 8 * 4
    assert kv == sum(len1) * 16384
    assert B.fused_kernel_hbm_bytes(cfg, 8, len1, 32) == 32 * sum(per.values())
    fl = B.kernel_flops(cfg, 8, len1)
    assert fl["oproj_ffn_swiglu"] == 2 * 8 * (4096 * D + 3 * D * F)


def test_backend_seam():
    cfg = reduced(get_config("samba-coe-expert-7b"))
    assert B.make_runner(cfg, 7).backend_name == "fused"
    ref = B.XlaPagedBackend(cfg)
    assert B.make_runner(cfg, 7, backend=ref).backend_name == "xla"
    be = B.FusedPagedBackend(cfg)
    assert B.make_backend(be, cfg) is be
    # no name selects the reference body: it is reachable only as an object
    for name in ("xla", "fused", "dataflow"):
        with pytest.raises(TypeError, match="PagedBackend"):
            B.make_runner(cfg, 7, backend=name)
    for bad in (dataclasses.replace(cfg, qkv_bias=True),
                dataclasses.replace(cfg, act="gelu"),
                dataclasses.replace(cfg, norm="ln")):
        with pytest.raises(ValueError, match="dense RMSNorm/SwiGLU"):
            B.FusedPagedBackend(bad)

"""Each kernel's plain PyTorch version (``ref.py``) against the JAX package's
Pallas kernel run in interpret mode, on the same numpy inputs, at f32 within
atol 1e-5 (the two sum in different orders). On CPU tensors the port's
wrappers run exactly these plain versions and launch nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import decode_paged as jax_decode_paged
from repro.kernels.fused_decode.kernel import (
    oproj_ffn_swiglu as jax_oproj_ffn_swiglu,
    qkv_rope_paged as jax_qkv_rope_paged)
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import decode_paged
from repro_torch.kernels.flash_attention.ref import (decode_paged_ref,
                                                     decode_paged_split_ref)
from repro_torch.kernels.fused_decode.ops import (oproj_ffn_swiglu,
                                                  qkv_rope_paged)
from repro_torch.kernels.fused_decode.ref import (oproj_ffn_swiglu_ref,
                                                  qkv_rope_paged_ref,
                                                  rope_inv_freq)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])   # G = 1, 2, 4
def test_decode_paged_plain_matches_pallas(hq, hkv):
    B, dh, block, maxb = 5, 32, 8, 3
    rows = B * maxb + 1                       # + scratch
    scratch = rows - 1
    rs = np.random.RandomState(0)
    q = rs.standard_normal((B, hq, dh)).astype(np.float32)
    kp = rs.standard_normal((rows, block, hkv, dh)).astype(np.float32)
    vp = rs.standard_normal((rows, block, hkv, dh)).astype(np.float32)
    tables = rs.permutation(rows - 1)[:B * maxb].reshape(B, maxb) \
        .astype(np.int32)
    tables[3] = scratch                       # inactive lane on scratch
    # one token, mid-block, exactly one block, inactive, straddling block 2
    len1 = np.asarray([1, 5, 8, 1, 17], np.int32)
    want = jax_decode_paged(*map(jnp.asarray, (q, kp, vp, tables, len1)),
                            interpret=True)
    got = decode_paged_ref(*map(_t, (q, kp, vp, tables, len1)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_decode_paged_split_plain_matches_pallas():
    """The card kernel's arithmetic written plainly (each chunk of positions
    to its partial, merged in chunk order) against the Pallas kernel and
    decode_paged_ref, at G 1/2/4, for chunks that are a multiple of the
    block (16 at block 8) and that end inside a page (12), at the chunk
    edges: 1, C - 1, C, C + 1, 2 C + 1, maxb * block and past it (not
    attended), and an inactive lane on the scratch row."""
    B, dh, block, maxb = 8, 32, 8, 5
    rows = B * maxb + 1
    rs = np.random.RandomState(5)
    for hq, hkv in ((4, 4), (4, 2), (8, 2)):
        q = rs.standard_normal((B, hq, dh)).astype(np.float32)
        kp = rs.standard_normal((rows, block, hkv, dh)).astype(np.float32)
        vp = rs.standard_normal((rows, block, hkv, dh)).astype(np.float32)
        tables = rs.permutation(rows - 1)[:B * maxb].reshape(B, maxb) \
            .astype(np.int32)
        tables[3] = rows - 1                  # inactive lane on scratch
        for C in (16, 12):
            len1 = np.asarray([1, C - 1, C, 1, C + 1, 2 * C + 1,
                               maxb * block, maxb * block + 3], np.int32)
            args = (q, kp, vp, tables, len1)
            want = np.asarray(jax_decode_paged(*map(jnp.asarray, args),
                                               interpret=True))
            got = decode_paged_split_ref(*map(_t, args), C)
            assert torch.isfinite(got).all()
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
            np.testing.assert_allclose(
                got.numpy(), decode_paged_ref(*map(_t, args)).numpy(),
                atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_qkv_rope_paged_plain_matches_pallas(n_kv):
    B, D, n_q, dh = 4, 128, 4, 32
    rs = np.random.RandomState(1)
    x = rs.standard_normal((B, D)).astype(np.float32)
    scale = rs.standard_normal((D,)).astype(np.float32)
    wq = (rs.standard_normal((D, n_q, dh)) * 0.05).astype(np.float32)
    wk = (rs.standard_normal((D, n_kv, dh)) * 0.05).astype(np.float32)
    wv = (rs.standard_normal((D, n_kv, dh)) * 0.05).astype(np.float32)
    pos = np.asarray([0, 3, 17, 100], np.int32)
    want = jax_qkv_rope_paged(*map(jnp.asarray, (x, scale, wq, wk, wv, pos)),
                              theta=10000.0, interpret=True)
    inv = _t(rope_inv_freq(dh, 10000.0))
    got = qkv_rope_paged_ref(*map(_t, (x, scale, wq, wk, wv, pos)), inv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_oproj_ffn_swiglu_plain_matches_pallas():
    B, D, F, HD = 4, 128, 256, 128
    rs = np.random.RandomState(3)
    x = rs.standard_normal((B, D)).astype(np.float32)
    attn = rs.standard_normal((B, HD)).astype(np.float32)
    wo = (rs.standard_normal((HD, D)) * 0.05).astype(np.float32)
    scale = rs.standard_normal((D,)).astype(np.float32)
    wg = (rs.standard_normal((D, F)) * 0.05).astype(np.float32)
    wu = (rs.standard_normal((D, F)) * 0.05).astype(np.float32)
    wd = (rs.standard_normal((F, D)) * 0.05).astype(np.float32)
    args = (x, attn, wo, scale, wg, wu, wd)
    want = jax_oproj_ffn_swiglu(*map(jnp.asarray, args), block_f=64,
                                interpret=True)
    got = oproj_ffn_swiglu_ref(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_wrappers_on_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    rs = np.random.RandomState(4)
    rt.reset_launches()
    q = _t(rs.standard_normal((2, 4, 32)).astype(np.float32))
    kp = _t(rs.standard_normal((5, 8, 2, 32)).astype(np.float32))
    vp = _t(rs.standard_normal((5, 8, 2, 32)).astype(np.float32))
    tb = torch.tensor([[0, 1], [2, 4]], dtype=torch.int32)
    l1 = torch.tensor([9, 3], dtype=torch.int32)
    assert torch.equal(decode_paged(q, kp, vp, tb, l1),
                       decode_paged_ref(q, kp, vp, tb, l1))
    x = _t(rs.standard_normal((2, 64)).astype(np.float32))
    w = [_t(rs.standard_normal(s).astype(np.float32))
         for s in ((64, 4, 32), (64, 2, 32), (64, 2, 32))]
    pos = torch.tensor([1, 7], dtype=torch.int32)
    inv = _t(rope_inv_freq(32, 10000.0))
    for a, b in zip(qkv_rope_paged(x, torch.ones(64), *w, pos),
                    qkv_rope_paged_ref(x, torch.ones(64), *w, pos, inv)):
        assert torch.equal(a, b)
    e = [_t(rs.standard_normal(s).astype(np.float32))
         for s in ((2, 128), (128, 64), (64,), (64, 96), (64, 96), (96, 64))]
    assert torch.equal(oproj_ffn_swiglu(x, *e), oproj_ffn_swiglu_ref(x, *e))
    assert rt.launch_counts() == {k: 0 for k in rt.launch_counts()}

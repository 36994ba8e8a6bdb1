"""``flash_prefill_bwd`` at the edges of its tiles on the card: the dK/dV
kernel's 128-key tiles (64 keys a warpgroup, 64-row q tiles) and the dQ
kernel's 128-row q tiles (64-key tiles). Lengths S 1, 63, 65, 127, 129,
257 and 513; windows of 17, 64 and 128, with and without the causal mask
(a band narrower than a tile, one that is neither causal nor fills a
tile, and S below a tile); G 1, 2, 4, 8; every width d 32 / 64 / 128.
Every test carries the ``gpu`` marker and skips, from inside a fixture,
where no card is present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_flash_bwd_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerance: dq, dk, dv each within a relative L2 error of 2^-6 of
``attention_bwd_ref`` in f32 on the same bf16 inputs (the kernel rounds p
and ds to bf16 for its products and its outputs to bf16: a few bf16
units). At S 1 every row attends its one key with p = 1, so ds = p (dp -
di) and with it dq and dk vanish: both results are rounding noise there,
and those two are held instead to an absolute 2^-6 of dv's largest
element. Two calls agree bit for bit, and the gradients autograd takes
through ``ops.attention`` equal the direct call's."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt

pytestmark = pytest.mark.gpu

BWD_REL_L2 = 2.0 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rs, shape, dev):
    return torch.as_tensor(rs.standard_normal(shape), dtype=torch.float32,
                           device=dev).to(torch.bfloat16)


def _rel_l2(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


# (d, G, S, causal, window)
CASES = [
    # causal: S below, at and past each tile's edges
    (32, 1, 1, True, 0), (64, 2, 63, True, 0), (128, 1, 65, True, 0),
    (32, 8, 127, True, 0), (64, 1, 129, True, 0), (128, 8, 257, True, 0),
    # causal with a window: narrower than a 64-row tile, one tile, two
    (128, 2, 257, True, 17), (64, 4, 300, True, 64),
    (32, 2, 513, True, 128), (128, 8, 129, True, 64),
    # a window alone (no causal mask): keys after each row are attended
    (128, 1, 129, False, 17), (64, 8, 257, False, 64),
    (128, 4, 300, False, 128), (32, 1, 65, False, 17),
    (128, 8, 1, False, 17), (64, 1, 63, False, 128),
]


@pytest.mark.parametrize("d,G,S,causal,window", CASES)
def test_backward_at_tile_edges(dev, d, G, S, causal, window):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    rs = np.random.RandomState(7 * d + G + S + window)
    B, Hkv = 2, 2
    q = _t(rs, (B, S, Hkv * G, d), dev)
    k, v = _t(rs, (B, S, Hkv, d), dev), _t(rs, (B, S, Hkv, d), dev)
    do = _t(rs, (B, S, Hkv * G, d), dev)
    o, lse = ops.attention_lse(q, k, v, causal=causal, window=window)
    rt.reset_launches()
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                            window=window)
    again = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert rt.launch_counts()["flash_prefill_bwd"] == 2
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, a), f"{name}: two calls differ"
        if S == 1 and name != "dv":
            assert torch.isfinite(g).all()
            big = float(g.float().abs().max())
            assert big <= BWD_REL_L2 * float(want[2].abs().max()), \
                f"{name}: {big} where it vanishes"
            continue
        err = _rel_l2(g, w)
        assert err < BWD_REL_L2, f"{name}: rel L2 {err}"
    # the same through autograd: attention routes to FlashAttention
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.attention(qg, kg, vg, causal=causal, window=window)
    out.backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), (qg, kg, vg), got):
        assert torch.equal(t.grad, g), name


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 1000)])
def test_backward_with_more_key_tiles_than_sms(dev, causal, window):
    """One (batch, kv head) with more 128-key tiles than the card has SMs:
    its CTAs cannot all be resident at once, and each q tile's dQ is summed
    in their launch order, so a CTA may only wait on one launched before
    it. G 2, d 64; against the plain version as above."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    S = rt.device_sms(dev.index or 0) * 128 + 300
    rs = np.random.RandomState(S)
    q, do = (_t(rs, (1, S, 2, 64), dev) for _ in range(2))
    k, v = (_t(rs, (1, S, 1, 64), dev) for _ in range(2))
    o, lse = ops.attention_lse(q, k, v, causal=causal, window=window)
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                            window=window)
    again = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), f"{name}: two calls differ"
        err = _rel_l2(g, w)
        assert err < BWD_REL_L2, f"{name}: rel L2 {err}"

"""The port's dense-cache decode kernels (``qkv_rope``, ``decode``,
``ffn_swiglu``) and ``decoder_layer_step`` against their plain PyTorch
versions, on the card. Every test here carries the ``gpu`` marker and
skips, from inside a fixture, where no card is present. Run them on an H100
with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_dense_kernels_gpu.py

This file imports no JAX: the machine with the card has none.

The kernels take bf16 (the served type). Tolerance: kernel and plain version
both accumulate in f32 and round to bf16 once, so they differ by summation
order plus at most one rounding of the output: two units in the last place
of the largest value (2^-7 relative, at least 2^-7 absolute).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import decode
from repro_torch.kernels.flash_attention.ref import decode_attention_ref
from repro_torch.kernels.fused_decode.ops import (decoder_layer_step,
                                                  ffn_swiglu, qkv_rope)
from repro_torch.kernels.fused_decode.ref import (decoder_layer_step_ref,
                                                  ffn_swiglu_ref,
                                                  qkv_rope_ref)

pytestmark = pytest.mark.gpu

BIG = 1.0e4          # cache fill past ``length``: a read would show


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    err = float((got.float() - ref.float()).abs().max())
    tol = 2.0 ** -7 * max(float(ref.float().abs().max()), 1.0)
    assert torch.isfinite(got.float()).all()
    assert got.dtype == torch.bfloat16
    assert err <= tol, (err, tol)


def _t(rs, shape, dev, scale=1.0):
    return torch.as_tensor(rs.standard_normal(shape) * scale,
                           dtype=torch.float32, device=dev).to(torch.bfloat16)


def test_decode_kernel_matches_plain(dev):
    """G in {1, 2, 4}, dh in {32, 64, 128}; lengths 1, either side of the
    kernel's position step (8 warps x 32 / (dh / EPL) tokens: 32 at dh = 128,
    64 at dh = 64, 128 at dh = 32) and the full cache."""
    B, S = 3, 300
    for hq, hkv, dh in ((4, 4, 128), (8, 4, 64), (8, 2, 32), (32, 32, 128)):
        rs = np.random.RandomState(dh + hq)
        q = _t(rs, (B, hq, dh), dev)
        kc, vc = _t(rs, (B, S, hkv, dh), dev), _t(rs, (B, S, hkv, dh), dev)
        step = 8 * 32 // (dh // (16 if hq // hkv <= 2 else 8))
        for length in (1, step - 1, step, step + 1, S):
            k2, v2 = kc.clone(), vc.clone()
            k2[:, length:], v2[:, length:] = BIG, BIG
            rt.reset_launches()
            got = decode(q, k2, v2, length)
            torch.cuda.synchronize()
            assert rt.launch_counts()["flash_decode"] == 1
            _close(got, decode_attention_ref(q, kc[:, :length],
                                             vc[:, :length], length))


def test_qkv_rope_kernel_matches_plain(dev):
    # the 7B widths at 8 and 16 lanes; dh 32; partial rotation at dh 64 and
    # 128 (partners 32 and 16 columns apart); dh 256 (a column group of four
    # tiles), fully and half rotated; 40 lanes (three slices of at most 16)
    for D, n_q, n_kv, dh, B, frac in ((4096, 32, 32, 128, 8, 1.0),
                                      (4096, 32, 32, 128, 16, 1.0),
                                      (128, 4, 2, 32, 3, 1.0),
                                      (512, 8, 2, 64, 11, 0.5),
                                      (256, 4, 1, 128, 5, 0.5),
                                      (512, 4, 1, 256, 5, 1.0),
                                      (512, 4, 1, 256, 3, 0.5),
                                      (256, 4, 1, 128, 40, 0.5)):
        rs = np.random.RandomState(D + dh)
        H = n_q + 2 * n_kv
        x = _t(rs, (B, D), dev)
        scale = _t(rs, (D,), dev)
        w = _t(rs, (D, H * dh), dev, D ** -0.5)
        kw = dict(n_q=n_q, n_kv=n_kv, dh=dh, theta=10000.0, rope_frac=frac)
        for pos in (0, 1, 777):
            rt.reset_launches()
            got = qkv_rope(x, scale, w, pos, **kw)
            torch.cuda.synchronize()
            assert rt.launch_counts()["qkv_rope"] == 1
            assert got.shape == (H, B, dh)
            _close(got, qkv_rope_ref(x, scale, w, pos, **kw))


def test_ffn_swiglu_kernel_matches_plain_both_forms(dev):
    # the 7B widths at 1, 8 and 16 lanes; F no multiple of the weight
    # stream's 64-column tile (200) or 64-row k-block (328); 40 lanes (three
    # weight streams of at most 16)
    for D, F, B in ((4096, 11008, 8), (4096, 11008, 1), (4096, 11008, 16),
                    (128, 256, 3), (256, 200, 9), (128, 328, 16),
                    (512, 1024, 40)):
        rs = np.random.RandomState(D + F)
        args = (_t(rs, (B, D), dev), _t(rs, (D,), dev),
                _t(rs, (D, F), dev, D ** -0.5), _t(rs, (D, F), dev, D ** -0.5),
                _t(rs, (F, D), dev, F ** -0.5))
        for residual in (True, False):
            rt.reset_launches()
            got = ffn_swiglu(*args, residual=residual)
            torch.cuda.synchronize()
            # the partial form has a launch count of its own
            assert rt.launch_counts()["ffn_swiglu" if residual else
                                      "ffn_swiglu[residual=False]"] == 1
            _close(got, ffn_swiglu_ref(*args, residual=residual))


def test_decoder_layer_step_kernels_match_plain(dev):
    B, S, D, n_q, n_kv, dh, F, pos = 5, 96, 512, 8, 4, 64, 768, 70
    rs = np.random.RandomState(9)
    p = {"attn_norm": _t(rs, (D,), dev),
         "w_qkv": _t(rs, (D, (n_q + 2 * n_kv) * dh), dev, D ** -0.5),
         "w_o": _t(rs, (n_q * dh, D), dev, (n_q * dh) ** -0.5),
         "mlp_norm": _t(rs, (D,), dev),
         "w_gate": _t(rs, (D, F), dev, D ** -0.5),
         "w_up": _t(rs, (D, F), dev, D ** -0.5),
         "w_down": _t(rs, (F, D), dev, F ** -0.5)}
    x = _t(rs, (B, D), dev)
    kc, vc = _t(rs, (B, S, n_kv, dh), dev), _t(rs, (B, S, n_kv, dh), dev)
    kc[:, pos + 1:], vc[:, pos + 1:] = BIG, BIG
    kw = dict(n_q=n_q, n_kv=n_kv, dh=dh, theta=10000.0)
    rt.reset_launches()
    y, k2, v2 = decoder_layer_step(x, p, kc.clone(), vc.clone(), pos, **kw)
    torch.cuda.synchronize()
    counts = rt.launch_counts()
    assert all(counts[k] == 1 for k in ("qkv_rope", "flash_decode",
                                        "ffn_swiglu"))
    yr, kr, vr = decoder_layer_step_ref(x, p, kc.clone(), vc.clone(), pos,
                                        **kw)
    _close(y, yr)
    _close(k2[:, pos], kr[:, pos])
    _close(v2[:, pos], vr[:, pos])
    assert torch.equal(k2[:, :pos], kc[:, :pos])


def test_dense_kernel_results_repeat_bit_for_bit(dev):
    """Every sum runs in a fixed order: two launches agree exactly."""
    rs = np.random.RandomState(3)
    B, S, D, F, n_q, n_kv, dh = 8, 512, 512, 1024, 8, 2, 64
    x, scale = _t(rs, (B, D), dev), _t(rs, (D,), dev)
    w = _t(rs, (D, (n_q + 2 * n_kv) * dh), dev, 0.05)
    ffn = (x, scale, _t(rs, (D, F), dev, 0.05), _t(rs, (D, F), dev, 0.05),
           _t(rs, (F, D), dev, 0.05))
    q = _t(rs, (B, n_q, dh), dev)
    kc, vc = _t(rs, (B, S, n_kv, dh), dev), _t(rs, (B, S, n_kv, dh), dev)
    # the QKV stream at dh 256 (four tiles a group) and at 7B (up to three
    # splits of a column group)
    w256 = _t(rs, (D, 6 * 256), dev, 0.05)
    x7, s7 = _t(rs, (B, 4096), dev), _t(rs, (4096,), dev)
    w7 = _t(rs, (4096, 96 * 128), dev, 4096 ** -0.5)
    runs = [(qkv_rope(x, scale, w, 33, n_q=n_q, n_kv=n_kv, dh=dh),
             decode(q, kc, vc, 400), ffn_swiglu(*ffn),
             ffn_swiglu(*ffn, residual=False),
             qkv_rope(x, scale, w256, 4000, n_q=4, n_kv=1, dh=256),
             qkv_rope(x7, s7, w7, 4095, n_q=32, n_kv=32, dh=128))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)

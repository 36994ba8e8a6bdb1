"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here carries the ``gpu`` marker and skips, from
inside the test, where no card is present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

This file imports no JAX: the machine with the card has none.

The kernels take bf16 (the served type). Tolerance: kernel and plain version
both accumulate in f32 and round to bf16 once, so they differ by summation
order plus at most one rounding of the output: two units in the last place
of the largest value (2^-7 relative).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import decode_paged
from repro_torch.kernels.flash_attention.ref import decode_paged_ref
from repro_torch.kernels.fused_decode.ops import (oproj_ffn_swiglu,
                                                  qkv_rope_paged)
from repro_torch.kernels.fused_decode.ref import (oproj_ffn_swiglu_ref,
                                                  qkv_rope_paged_ref,
                                                  rope_inv_freq)

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("hq,hkv,dh", [(32, 32, 128), (8, 4, 64), (8, 2, 128),
                                       (4, 1, 32)])
def test_decode_paged_kernel_matches_plain(dev, hq, hkv, dh):
    B, block, maxb = 8, 16, 32
    rows = B * maxb + 1
    rs = np.random.RandomState(0)
    q = _t(rs, (B, hq, dh), dev)
    kp = _t(rs, (rows, block, hkv, dh), dev)
    vp = _t(rs, (rows, block, hkv, dh), dev)
    tables = torch.as_tensor(rs.permutation(rows - 1)[:B * maxb]
                             .reshape(B, maxb), dtype=torch.int32, device=dev)
    tables[3] = rows - 1                    # an inactive lane on scratch
    len1 = torch.as_tensor([1, 15, 16, 1, 17, 255, 300, 512],
                           dtype=torch.int32, device=dev)
    rt.reset_launches()
    got = decode_paged(q, kp, vp, tables, len1)
    torch.cuda.synchronize()
    assert rt.launch_counts()["decode_paged"] == 1
    _close(got, decode_paged_ref(q, kp, vp, tables, len1))


# few test cases per file keep the xdist work queue of the whole suite in
# its usual order: the next two cases loop over their shapes
def test_qkv_rope_paged_kernel_matches_plain(dev):
    for D, hq, hkv, dh, B in ((4096, 32, 32, 128, 8), (128, 4, 2, 32, 3),
                              (512, 8, 2, 64, 11)):
        rs = np.random.RandomState(1)
        x = _t(rs, (B, D), dev)
        scale = _t(rs, (D,), dev)
        wq = _t(rs, (D, hq, dh), dev, D ** -0.5)
        wk = _t(rs, (D, hkv, dh), dev, D ** -0.5)
        wv = _t(rs, (D, hkv, dh), dev, D ** -0.5)
        pos = torch.as_tensor(rs.randint(0, 512, (B,)), dtype=torch.int32,
                              device=dev)
        got = qkv_rope_paged(x, scale, wq, wk, wv, pos)
        inv = torch.as_tensor(rope_inv_freq(dh, 10000.0), device=dev)
        ref = qkv_rope_paged_ref(x, scale, wq, wk, wv, pos, inv)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            _close(g, r)


# (D, Hq*dh, F, B): the 7B widths at 1, 8 and 16 lanes; a K that is no
# multiple of the weight stream's 64-row k-block (Hq*dh 520, F 328 as the
# down-projection's K), N no multiple of its 64-column tile (F 200, 328),
# D 128, and 40 lanes (three weight streams of at most 16)
EPI_SHAPES = ((4096, 4096, 11008, 8), (4096, 4096, 11008, 1),
              (4096, 4096, 11008, 16), (128, 128, 256, 3), (256, 512, 200, 9),
              (128, 520, 328, 16), (512, 512, 1024, 40))


def _epilogue_args(rs, D, HD, F, B, dev):
    return (_t(rs, (B, D), dev), _t(rs, (B, HD), dev),
            _t(rs, (HD, D), dev, HD ** -0.5), _t(rs, (D,), dev),
            _t(rs, (D, F), dev, D ** -0.5), _t(rs, (D, F), dev, D ** -0.5),
            _t(rs, (F, D), dev, F ** -0.5))


def test_oproj_ffn_swiglu_kernel_matches_plain(dev):
    for D, HD, F, B in EPI_SHAPES:
        args = _epilogue_args(np.random.RandomState(2), D, HD, F, B, dev)
        rt.reset_launches()
        got = oproj_ffn_swiglu(*args)
        ref = oproj_ffn_swiglu_ref(*args)
        torch.cuda.synchronize()
        assert rt.launch_counts()["oproj_ffn_swiglu"] == 1
        _close(got, ref)


def test_oproj_ffn_swiglu_counters_reset_between_shapes(dev):
    """The fix-up counters live in a workspace kept between calls and reset
    by the kernels: calls at alternating shapes stay right and repeat."""
    shapes = ((512, 512, 1024, 8), (256, 520, 200, 9))
    args = [_epilogue_args(np.random.RandomState(4), *s, dev) for s in shapes]
    first = [oproj_ffn_swiglu(*a) for a in args]
    again = [oproj_ffn_swiglu(*a) for a in args]
    torch.cuda.synchronize()
    for a, f, g in zip(args, first, again):
        _close(f, oproj_ffn_swiglu_ref(*a))
        assert torch.equal(f, g)


def test_kernel_results_repeat_bit_for_bit(dev):
    """Every sum runs in a fixed order: two launches agree exactly, also at
    the 7B widths, where the fix-up sums up to three splits of a tile."""
    rs = np.random.RandomState(3)
    D, HD, F, B = 512, 512, 1024, 8
    small = [_t(rs, s, dev, 0.05)
             for s in ((B, D), (B, HD), (HD, D), (D,), (D, F), (D, F), (F, D))]
    big = _epilogue_args(np.random.RandomState(3), 4096, 4096, 11008, 8, dev)
    for args in (small, big):
        a = oproj_ffn_swiglu(*args)
        b = oproj_ffn_swiglu(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b)

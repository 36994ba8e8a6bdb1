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
from repro_torch.kernels.flash_attention.ops import decode_paged, split_chunk
from repro_torch.kernels.flash_attention.ref import (decode_paged_ref,
                                                     decode_paged_split_ref)
from repro_torch.kernels.fused_decode.ops import (ffn_swiglu, oproj_ffn_swiglu,
                                                  qkv_rope, qkv_rope_paged)
from repro_torch.kernels.fused_decode.ref import (ffn_swiglu_ref,
                                                  oproj_ffn_swiglu_ref,
                                                  qkv_rope_paged_ref,
                                                  qkv_rope_ref,
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


def _rows_close(got, ref):
    """_close, and every head's dh values within 2^-7 relative L2 error."""
    _close(got, ref)
    g, r = got.float(), ref.float()
    err = float(((g - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30))
                .max())
    assert err <= 2.0 ** -7, err


def _paged_args(rs, B, hq, hkv, dh, block, maxb, len1, dev, inactive=3):
    """q, pools, tables (distinct rows, lane ``inactive`` on the scratch
    row unless None) and len1 of one paged decode call."""
    rows = B * maxb + 1
    tables = torch.as_tensor(rs.permutation(rows - 1)[:B * maxb]
                             .reshape(B, maxb), dtype=torch.int32, device=dev)
    if inactive is not None:
        tables[inactive] = rows - 1
    return (_t(rs, (B, hq, dh), dev), _t(rs, (rows, block, hkv, dh), dev),
            _t(rs, (rows, block, hkv, dh), dev), tables,
            torch.as_tensor(len1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("hq,hkv,dh", [(32, 32, 128), (8, 4, 64), (8, 2, 128),
                                       (4, 1, 32), (12, 4, 64), (40, 8, 128),
                                       (12, 2, 128), (24, 2, 128),
                                       (32, 2, 128), (16, 1, 256)])
def test_decode_paged_kernel_matches_plain(dev, hq, hkv, dh):
    """One launch, held to both plain versions (the masked softmax and the
    kernel's chunked arithmetic), at ragged lengths, at the chunk edges (C
    positions a CTA; at block 12 a chunk ends inside a page; len1 past
    maxb * block is not attended), and with every lane full."""
    B, C = 8, split_chunk()
    for block, maxb in ((16, 32), (12, 43)):
        S = block * maxb
        for len1, inactive in (
                ([1, 15, 16, 1, 17, 255, 300, 512], 3),
                ([1, C - 1, C, 1, C + 1, 2 * C + 1, S, S + 5], 3),
                ([S] * B, None)):
            args = _paged_args(np.random.RandomState(0), B, hq, hkv, dh,
                               block, maxb, len1, dev, inactive)
            rt.reset_launches()
            got = decode_paged(*args)
            torch.cuda.synchronize()
            assert rt.launch_counts()["decode_paged"] == 1
            _rows_close(got, decode_paged_ref(*args))
            _rows_close(got, decode_paged_split_ref(*args, C))


# (Hq, Hkv, dh): G 3, 5, 6, 12 and 16 (the variants' groups), 16 at dh 256
ANY_GROUP = ((12, 4, 64), (40, 8, 128), (12, 2, 128), (24, 2, 128),
             (32, 2, 128), (16, 1, 256), (48, 3, 32))


@pytest.mark.parametrize("hq,hkv,dh", ANY_GROUP)
def test_decode_kernels_take_any_group(dev, hq, hkv, dh):
    """Both decode kernels at a G outside 1/2/4/8, where a paged CTA serves
    one query and a dense CTA the whole group: each launch held to its
    plain version row by row (a row stored at the wrong query would land
    on another head's rows), two calls bit-equal, one launch counted a
    call."""
    from repro_torch.kernels.flash_attention.ops import decode
    from repro_torch.kernels.flash_attention.ref import decode_attention_ref
    rs = np.random.RandomState(hq // hkv)
    args = _paged_args(rs, 8, hq, hkv, dh, 16, 32,
                       [1, 17, 128, 1, 129, 300, 511, 512], dev)
    q, kc, vc = (_t(rs, (3, hq, dh), dev), _t(rs, (3, 300, hkv, dh), dev),
                 _t(rs, (3, 300, hkv, dh), dev))
    rt.reset_launches()
    got = decode_paged(*args)
    again = decode_paged(*args)
    dense = [decode(q, kc, vc, n) for n in (1, 77, 300)]
    torch.cuda.synchronize()
    assert rt.launch_counts()["decode_paged"] == 2
    assert rt.launch_counts()["flash_decode"] == 3
    _rows_close(got, decode_paged_ref(*args))
    assert torch.equal(got, again)
    for n, o in zip((1, 77, 300), dense):
        _rows_close(o, decode_attention_ref(q, kc[:, :n], vc[:, :n], n))


def test_decode_kernels_refuse_what_they_are_not_built_for(dev):
    """A CUDA tensor at a head width the kernels lack raises; it never
    takes the plain version."""
    from repro_torch.kernels.flash_attention.ops import decode
    rs = np.random.RandomState(0)
    q, kc = _t(rs, (2, 4, 96), dev), _t(rs, (2, 8, 2, 96), dev)
    rt.reset_launches()
    with pytest.raises(ValueError, match="dh"):
        decode(q, kc, kc, 4)
    args = _paged_args(rs, 2, 4, 2, 96, 8, 2, [3, 9], dev, None)
    with pytest.raises(ValueError, match="dh"):
        decode_paged(*args)
    assert rt.launch_counts().get("decode_paged", 0) == 0
    assert rt.launch_counts().get("flash_decode", 0) == 0


def test_decode_paged_counters_reset_between_calls(dev):
    """The merge counters live in a workspace kept between calls and are
    reset by the kernel: calls at two shapes (dh 128 G 1 at block 16; dh
    256 G 8 at block 8) on two pools each, interleaved, stay right and
    repeat bit for bit."""
    rs = np.random.RandomState(6)
    calls = []
    for B, hq, hkv, dh, block, maxb in ((8, 32, 32, 128, 16, 32),
                                        (5, 16, 2, 256, 8, 40)):
        for _ in range(2):
            len1 = rs.randint(1, block * maxb + 1, size=B)
            calls.append(_paged_args(rs, B, hq, hkv, dh, block, maxb, len1,
                                     dev))
    first = [decode_paged(*a) for a in calls]
    again = [decode_paged(*a) for a in calls]
    torch.cuda.synchronize()
    for a, f, g in zip(calls, first, again):
        _rows_close(f, decode_paged_ref(*a))
        assert torch.equal(f, g)


# (D, Hq, Hkv, dh, B): the 7B widths at 8 and 16 lanes (one weight
# stream), dh 32 with 64 k / v columns and with Hq 3, Hkv 1 (wq and wk end
# inside a 64-column tile: padded), dh 64 at 11 lanes, dh 256 (a column
# group of four tiles), 40 lanes (three slices of at most 16)
QKV_PAGED_SHAPES = ((4096, 32, 32, 128, 8), (4096, 32, 32, 128, 16),
                    (128, 4, 2, 32, 3), (128, 3, 1, 32, 16),
                    (512, 8, 2, 64, 11), (512, 4, 1, 256, 5),
                    (256, 4, 2, 64, 40))


def _qkv_paged_args(rs, D, hq, hkv, dh, B, dev):
    return (_t(rs, (B, D), dev), _t(rs, (D,), dev),
            _t(rs, (D, hq, dh), dev, D ** -0.5),
            _t(rs, (D, hkv, dh), dev, D ** -0.5),
            _t(rs, (D, hkv, dh), dev, D ** -0.5),
            torch.as_tensor(rs.randint(0, 4096, (B,)), dtype=torch.int32,
                            device=dev))


# few test cases per file keep the xdist work queue of the whole suite in
# its usual order: the next two cases loop over their shapes
def test_qkv_rope_paged_kernel_matches_plain(dev):
    for D, hq, hkv, dh, B in QKV_PAGED_SHAPES:
        args = _qkv_paged_args(np.random.RandomState(1), D, hq, hkv, dh, B,
                               dev)
        rt.reset_launches()
        got = qkv_rope_paged(*args)
        inv = torch.as_tensor(rope_inv_freq(dh, 10000.0), device=dev)
        ref = qkv_rope_paged_ref(*args, inv)
        torch.cuda.synchronize()
        assert rt.launch_counts()["qkv_rope_paged"] == 1
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
    """The fix-up counters live in workspaces kept between calls (one for
    the FFN kernels, one for the QKV kernels) and reset by the kernels:
    calls of all four weight-stream kernels at alternating shapes,
    interleaved, stay right and repeat bit for bit."""
    rs = np.random.RandomState(4)
    calls = []
    for D, HD, F, B in ((512, 512, 1024, 8), (256, 520, 200, 9)):
        a = _epilogue_args(rs, D, HD, F, B, dev)
        calls.append((lambda a=a: oproj_ffn_swiglu(*a),
                      lambda a=a: oproj_ffn_swiglu_ref(*a)))
        f = (a[0], a[3], a[4], a[5], a[6])
        calls.append((lambda f=f: ffn_swiglu(*f),
                      lambda f=f: ffn_swiglu_ref(*f)))
    for D, hq, hkv, dh, B in ((512, 8, 2, 64, 8), (128, 3, 1, 32, 16),
                              (512, 4, 1, 256, 5)):
        a = _qkv_paged_args(rs, D, hq, hkv, dh, B, dev)
        inv = torch.as_tensor(rope_inv_freq(dh, 10000.0), device=dev)
        calls.append((lambda a=a: qkv_rope_paged(*a),
                      lambda a=a, inv=inv: qkv_rope_paged_ref(*a, inv)))
        w = torch.cat([t.reshape(D, -1) for t in a[2:5]], 1).contiguous()
        kw = dict(n_q=hq, n_kv=hkv, dh=dh, rope_frac=0.5)
        calls.append((lambda a=a, w=w, kw=kw: qkv_rope(a[0], a[1], w, 77,
                                                        **kw),
                      lambda a=a, w=w, kw=kw: qkv_rope_ref(a[0], a[1], w, 77,
                                                            **kw)))
    first = [kern() for kern, _ in calls]
    again = [kern() for kern, _ in calls]
    torch.cuda.synchronize()
    for (_, plain), f, g in zip(calls, first, again):
        f = f if isinstance(f, tuple) else (f,)
        g = g if isinstance(g, tuple) else (g,)
        want = plain()
        for fi, gi, wi in zip(f, g, want if isinstance(want, tuple)
                              else (want,)):
            _close(fi, wi)
            assert torch.equal(fi, gi)


def test_kernel_results_repeat_bit_for_bit(dev):
    """Every sum runs in a fixed order: two launches agree exactly, also at
    the 7B widths, where the fix-up sums up to three splits of a tile and
    the paged decode merges up to eight chunks of a lane."""
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
    # the paged decode, whose lanes merge up to eight chunks at 7B
    args = _paged_args(rs, 8, 32, 32, 128, 16, 32,
                       [1, 15, 16, 1, 17, 255, 300, 512], dev)
    a, b = decode_paged(*args), decode_paged(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    # the QKV stream, whose column groups take up to three splits at 7B
    for shape in ((512, 8, 2, 64, 8), (4096, 32, 32, 128, 8),
                  (512, 4, 1, 256, 16)):
        args = _qkv_paged_args(rs, *shape, dev)
        a, b = qkv_rope_paged(*args), qkv_rope_paged(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))

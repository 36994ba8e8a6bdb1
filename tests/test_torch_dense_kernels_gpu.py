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
of the largest value (2^-7 relative, at least 2^-7 absolute). ``decode``
also rounds its probabilities to bf16 before the value product, as the
plain version does at another point (unnormalised against normalised), and
is held row by row within 2^-7 of each row's norm besides.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import decode, decode_plan
from repro_torch.kernels.flash_attention.ref import (decode_attention_ref,
                                                     decode_split_ref)
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


# chip_smoke.DECODE_ROW_REL_L2: each output row's relative L2 error
# against the chunked plain version
DECODE_ROW_REL_L2 = 2.0 ** -7


def _rows_close(got, ref, tol=DECODE_ROW_REL_L2):
    g, w = got.float(), ref.float()
    err = float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30))
                .max())
    assert torch.isfinite(g).all()
    assert err <= tol, (err, tol)


def test_decode_kernel_matches_plain(dev):
    """G 1-20 (a tile of 16 query rows a CTA, a sibling CTA past 16), dh
    32-256; at the plan's chunk and at chunks of 16 (a quarter stage) and
    100 (a stage and a half): lengths 1, either side of a ring stage (64
    positions) and of the chunk, and the full cache, the positions past
    ``length`` poisoned."""
    B, S = 3, 300
    for hq, hkv, dh in ((4, 4, 128), (8, 4, 64), (8, 2, 32), (32, 32, 128),
                        (10, 2, 128), (12, 2, 64), (24, 2, 128), (32, 2, 32),
                        (16, 1, 256), (40, 2, 64), (20, 1, 256)):
        rs = np.random.RandomState(dh + hq)
        q = _t(rs, (B, hq, dh), dev)
        kc, vc = _t(rs, (B, S, hkv, dh), dev), _t(rs, (B, S, hkv, dh), dev)
        for chunk in (None, 16, 100):
            C = chunk or decode_plan(B, hkv, hq // hkv, dh, S,
                                     rt.device_sms(dev.index or 0)).chunk
            for length in sorted({1, 63, 64, 65, C - 1, C, C + 1, S}
                                 - {0}):
                k2, v2 = kc.clone(), vc.clone()
                k2[:, length:], v2[:, length:] = BIG, BIG
                rt.reset_launches()
                got = decode(q, k2, v2, length, chunk=chunk)
                torch.cuda.synchronize()
                assert rt.launch_counts()["flash_decode"] == 1
                _close(got, decode_attention_ref(q, kc[:, :length],
                                                 vc[:, :length], length))


def test_decode_kernel_matches_chunked_plain_row_by_row(dev):
    """Each output row against the chunked plain version at the plan's
    chunk (the kernel's own arithmetic: partials merged in chunk order, p
    rounded to bf16) and against the plain version, within 2^-7 of its
    norm: row 6's G 1 and rows 6′'s G 5/6/12/16 (dh 128) and 16 (dh 256),
    and G 20, at B 4 over 1024 positions of a 1100-position cache; and row
    6's G 1 at B 8 (256 pairs: every SM a CTA, the copies through L1)."""
    S, length = 1100, 1024
    for B, hq, hkv, dh in ((4, 32, 32, 128), (4, 40, 8, 128),
                           (4, 12, 2, 128), (4, 24, 2, 128),
                           (4, 32, 2, 128), (4, 16, 1, 256),
                           (4, 40, 2, 64), (8, 32, 32, 128)):
        rs = np.random.RandomState(hq * dh)
        q = _t(rs, (B, hq, dh), dev)
        kc, vc = _t(rs, (B, S, hkv, dh), dev), _t(rs, (B, S, hkv, dh), dev)
        plan = decode_plan(B, hkv, hq // hkv, dh, length,
                           rt.device_sms(dev.index or 0))
        assert plan.l1 or B < 8          # 256 pairs: more than any H100's SMs
        got = decode(q, kc, vc, length)
        _rows_close(got, decode_split_ref(q, kc, vc, length, plan.chunk))
        _rows_close(got, decode_attention_ref(q, kc, vc, length))


def test_decode_counters_reset_between_calls(dev):
    """The merge counters and partial slots live in a workspace kept
    between calls and the counters are reset by the kernel: split calls at
    three shapes (G 5 at dh 128, G 16 at dh 256, G 20 at dh 64, which has
    two tiles a kv head; at chunks of 128, 64 and 16), interleaved, stay
    right and repeat bit for bit."""
    rs = np.random.RandomState(7)
    calls = []
    for B, hq, hkv, dh, S, length, chunk in (
            (8, 40, 8, 128, 600, 517, 128), (4, 16, 1, 256, 300, 300, 64),
            (3, 40, 2, 64, 200, 131, 16)):
        for _ in range(2):
            calls.append(((_t(rs, (B, hq, dh), dev),
                           _t(rs, (B, S, hkv, dh), dev),
                           _t(rs, (B, S, hkv, dh), dev), length),
                          chunk))
    first = [decode(*a, chunk=c) for a, c in calls]
    again = [decode(*a, chunk=c) for a, c in calls]
    torch.cuda.synchronize()
    for (a, c), f, g in zip(calls, first, again):
        q, kc, vc, length = a
        assert torch.equal(f, g)
        _rows_close(f, decode_attention_ref(q, kc[:, :length],
                                            vc[:, :length], length))
        assert decode_plan(q.shape[0], kc.shape[2], q.shape[1] // kc.shape[2],
                           q.shape[2], length, rt.device_sms(dev.index or 0),
                           c).chunks > 1


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
    # decode split along S at G 12: the chunks' partials merged by the last
    # CTA of each (lane, kv head)
    q12 = _t(rs, (B, 24, 128), dev)
    k12, v12 = _t(rs, (B, S, 2, 128), dev), _t(rs, (B, S, 2, 128), dev)
    assert decode_plan(B, 2, 12, 128, 500, rt.device_sms(dev.index or 0)) \
        .chunks > 1
    # the QKV stream at dh 256 (four tiles a group) and at 7B (up to three
    # splits of a column group)
    w256 = _t(rs, (D, 6 * 256), dev, 0.05)
    x7, s7 = _t(rs, (B, 4096), dev), _t(rs, (4096,), dev)
    w7 = _t(rs, (4096, 96 * 128), dev, 4096 ** -0.5)
    runs = [(qkv_rope(x, scale, w, 33, n_q=n_q, n_kv=n_kv, dh=dh),
             decode(q, kc, vc, 400), decode(q12, k12, v12, 500),
             decode(q12, k12, v12, 500, chunk=16), ffn_swiglu(*ffn),
             ffn_swiglu(*ffn, residual=False),
             qkv_rope(x, scale, w256, 4000, n_q=4, n_kv=1, dh=256),
             qkv_rope(x7, s7, w7, 4095, n_q=32, n_kv=32, dh=128))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)

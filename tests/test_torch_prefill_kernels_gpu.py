"""The port's prefill kernels (``flash_prefill`` behind
``kernels.flash_attention.ops.attention`` and ``lru_scan``) against their
plain PyTorch versions, on the card. Every test here carries the ``gpu``
marker and skips, from inside a fixture, where no card is present. Run them
on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_prefill_kernels_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances. ``flash_prefill`` takes bf16; kernel and plain version both
accumulate in f32 and round the probabilities and the output to bf16, so
they differ by summation order plus roundings of the output: two units in
the last place of the largest value (2^-7 relative, at least 2^-7
absolute); and each query row's relative L2 error at most 2^-6, which
holds the rows of small values to their own scale (``chip_smoke.py``'s
``PREFILL_ROW_REL_L2``: an off-by-one mask edge reads 0.4 or more there).
``lru_scan`` takes f32; the kernel walks the sequence in order
and the plain version is a doubling scan, so they round in different
orders: 1e-5 of max(1, max |h|) (CPU trials at S = 3000 read at most 5e-7
of it).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.lru_scan.ops import lru_scan
from repro_torch.kernels.lru_scan.ref import lru_scan_ref

pytestmark = pytest.mark.gpu

BIG = 1.0e4          # fill past S in the over-allocated buffers
ROW_REL_L2 = 2.0 ** -6


def _row_rel_l2(got, want):
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _padded(rs, B, S, H, dh, dev):
    """A (B, S, H, dh) bf16 view into a buffer with 7 positions more per
    lane, filled with BIG: the view's batch stride is not S * H * dh, and
    a read past S would show."""
    x = torch.as_tensor(rs.standard_normal((B, S, H, dh)),
                        dtype=torch.float32, device=dev).to(torch.bfloat16)
    buf = torch.full((B, S + 7, H, dh), BIG, dtype=torch.bfloat16, device=dev)
    buf[:, :S] = x
    return buf[:, :S], x


def test_flash_prefill_matches_plain(dev):
    """G in {1, 2, 16}, dh in {32, 64, 128, 256}, S from 1 to 3000 (at and
    around the kernel's 128-row q tiles and its 64- and 128-key K/V tiles),
    window in {0, 48, 100, 2048} (48 and 100 are no multiple of a K/V
    tile); causal, as every prefill calls it."""
    for G, hkv, dh in ((1, 2, 64), (2, 2, 128), (16, 1, 256), (16, 1, 64),
                       (2, 1, 256), (1, 1, 128), (4, 1, 32)):
        for S in (1, 17, 63, 64, 65, 127, 128, 129, 191, 257, 3000):
            rs = np.random.RandomState(G * 1000 + dh + S)
            q, q0 = _padded(rs, 2, S, G * hkv, dh, dev)
            k, k0 = _padded(rs, 2, S, hkv, dh, dev)
            v, v0 = _padded(rs, 2, S, hkv, dh, dev)
            for window in (0, 48, 100, 2048):
                rt.reset_launches()
                got = attention(q, k, v, causal=True, window=window)
                again = attention(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
                assert rt.launch_counts()["flash_prefill"] == 2
                assert torch.equal(got, again)     # bit for bit
                want = attention_ref(q0, k0, v0, causal=True, window=window)
                err = float((got.float() - want.float()).abs().max())
                tol = 2.0 ** -7 * max(float(want.float().abs().max()), 1.0)
                assert got.dtype == torch.bfloat16
                assert torch.isfinite(got.float()).all()
                assert err <= tol, (G, dh, S, window, err, tol)
                row = _row_rel_l2(got, want)
                assert row <= ROW_REL_L2, (G, dh, S, window, row)


def test_flash_prefill_without_the_causal_mask(dev):
    rs = np.random.RandomState(3)
    q, q0 = _padded(rs, 1, 200, 4, 128, dev)
    k, k0 = _padded(rs, 1, 200, 2, 128, dev)
    v, v0 = _padded(rs, 1, 200, 2, 128, dev)
    for window in (0, 48):
        got = attention(q, k, v, causal=False, window=window)
        want = attention_ref(q0, k0, v0, causal=False, window=window)
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -7 * max(float(want.float().abs().max()), 1.0)
        assert _row_rel_l2(got, want) <= ROW_REL_L2


def test_flash_prefill_on_views_of_a_fused_buffer(dev):
    """q, k and v as head slices of one (B, S + 7, Hq + 2 Hkv, dh) buffer
    filled with BIG past S, as a fused qkv projection leaves them: the
    kernel reads each by its strides and nothing past S."""
    for B, S, hkv, G, dh, window in ((2, 129, 2, 2, 128, 0),
                                     (1, 300, 1, 16, 256, 100),
                                     (2, 65, 2, 4, 64, 48)):
        Hq, H = G * hkv, G * hkv + 2 * hkv
        rs = np.random.RandomState(S + dh)
        x = torch.as_tensor(rs.standard_normal((B, S, H, dh)),
                            dtype=torch.float32, device=dev).to(torch.bfloat16)
        buf = torch.full((B, S + 7, H, dh), BIG, dtype=torch.bfloat16,
                         device=dev)
        buf[:, :S] = x
        q, k, v = (buf[:, :S, :Hq], buf[:, :S, Hq:Hq + hkv],
                   buf[:, :S, Hq + hkv:])
        rt.reset_launches()
        got = attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert rt.launch_counts()["flash_prefill"] == 1
        want = attention_ref(x[:, :, :Hq], x[:, :, Hq:Hq + hkv],
                             x[:, :, Hq + hkv:], causal=True, window=window)
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -7 * max(float(want.float().abs().max()), 1.0)
        assert _row_rel_l2(got, want) <= ROW_REL_L2, (B, S, G, dh, window)


def test_flash_prefill_refuses_misaligned_views(dev):
    """A view whose rows do not start on 16 bytes, or whose strides are no
    multiple of 8 elements, raises: nothing falls back to the plain
    version."""
    buf = torch.zeros((1, 64, 2, 136), dtype=torch.bfloat16, device=dev)
    good = buf[..., :128]                   # stride 136: aligned rows
    for bad in (buf[..., 1:129],            # rows start 2 bytes off
                torch.zeros((1, 64, 2, 132), dtype=torch.bfloat16,
                            device=dev)[..., :128]):   # stride 132
        for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
            rt.reset_launches()
            with pytest.raises(ValueError):
                attention(*args, causal=True)
            assert rt.launch_counts()["flash_prefill"] == 0
    attention(good, good, good, causal=True)
    torch.cuda.synchronize()


def test_lru_scan_matches_plain(dev):
    """S from 1 to 3000, D a multiple of the 128-thread block and not."""
    for B, S, D in ((1, 1, 1), (2, 17, 130), (3, 300, 512), (4, 3000, 4096)):
        rs = np.random.RandomState(S + D)
        a = torch.as_tensor(rs.uniform(0.0, 1.0, (B, S, D)),
                            dtype=torch.float32, device=dev)
        b = torch.as_tensor(rs.standard_normal((B, S, D)),
                            dtype=torch.float32, device=dev)
        rt.reset_launches()
        got = lru_scan(a, b)
        again = lru_scan(a, b)
        torch.cuda.synchronize()
        assert rt.launch_counts()["lru_scan"] == 2
        assert torch.equal(got, again)
        want = lru_scan_ref(a, b)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), 1.0), (B, S, D, err)

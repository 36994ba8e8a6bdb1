"""The port's Monarch kernels (``monarch_fused`` behind
``kernels.monarch_fft.ops.monarch`` and ``monarch_conv_fused`` behind
``ops.monarch_conv``) against their plain PyTorch versions, on the card.
Every test here carries the ``gpu`` marker and skips, from inside a
fixture, where no card is present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_monarch_kernels_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances (``launch.monarch_fftconv``): kernel and plain version both
accumulate in f32 and round to bf16 at the same points, so they differ by
summation order and the roundings it flips: max |err| within 2^-7 of
max(1, max |plain|), and every output row within 2^-8 relative L2.
"""
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.monarch_fft import ref
from repro_torch.kernels.monarch_fft.ops import monarch, monarch_conv
from repro_torch.launch.monarch_fftconv import (MAX_ABS_REL, ROW_REL_L2,
                                                make_inputs, row_rel_l2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(label, got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, label
    assert torch.isfinite(got.float()).all(), label
    err = float((got.float() - want.float()).abs().max())
    tol = MAX_ABS_REL * max(1.0, float(want.float().abs().max()))
    assert err <= tol, f"{label}: max |err| {err} > {tol}"
    row = row_rel_l2(got, want)
    assert row <= ROW_REL_L2, f"{label}: row relative L2 {row}"


def test_monarch_matches_plain(dev):
    """JAX's test shapes, the 1M-point shape, a ragged batch with N1 != N2,
    and N2 = 2048 / 4096, where the kernel's N1 block shrinks to 32 / 16
    rows to fit shared memory."""
    for B, N1, N2 in ((2, 128, 256), (1, 256, 128), (3, 128, 128),
                      (16, 1024, 1024), (7, 384, 640), (2, 128, 2048),
                      (1, 64, 4096)):
        args, _ = make_inputs(B, N1, N2, dev, seed=B + N1 + N2)
        rt.reset_launches()
        got = monarch(*args)
        again = monarch(*args)
        assert rt.launch_counts()["monarch_fused"] == 2
        assert torch.equal(got, again), "not repeatable"
        _check(f"monarch {(B, N1, N2)}", got, ref.monarch_ref(*args))


def test_monarch_conv_matches_plain(dev):
    """As above for the conv; N2 = 2048 takes its 16-row N1 block."""
    for B, N1, N2 in ((2, 128, 256), (1, 256, 128), (2, 128, 128),
                      (16, 1024, 1024), (7, 384, 640), (1, 128, 2048)):
        m_args, c_args = make_inputs(B, N1, N2, dev, seed=B + N1 + N2)
        args = m_args + c_args
        rt.reset_launches()
        got = monarch_conv(*args)
        again = monarch_conv(*args)
        assert rt.launch_counts()["monarch_conv_fused"] == 2
        assert torch.equal(got, again), "not repeatable"
        _check(f"monarch_conv {(B, N1, N2)}", got,
               ref.monarch_conv_ref(*args))


def test_f32_and_untileable_shapes_raise(dev):
    """The kernels take bf16: f32 on the card raises TypeError. A shape the
    Pallas kernel takes but these kernels do not tile (N2 = 192) raises
    ValueError. Neither launches anything."""
    m_args, c_args = make_inputs(2, 128, 128, dev, dtype=torch.float32)
    rt.reset_launches()
    with pytest.raises(TypeError, match="bf16"):
        monarch(*m_args)
    with pytest.raises(TypeError, match="bf16"):
        monarch_conv(*m_args, *c_args)
    m_args, c_args = make_inputs(2, 128, 192, dev)
    with pytest.raises(ValueError, match="tiles"):
        monarch(*m_args)
    with pytest.raises(ValueError, match="tiles"):
        monarch_conv(*m_args, *c_args)
    assert rt.launch_counts()["monarch_fused"] == 0
    assert rt.launch_counts()["monarch_conv_fused"] == 0

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

The kernels tile each shape as ``ops.monarch_plan`` and
``ops.monarch_conv_plan`` say for the card (rows of N1 a CTA, the phase-1
slab; for the conv also its one front launch or its two passes): on an
H100 SXM the shapes below make the plans pick every combination they can,
each checked here against the plans themselves.
"""
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.monarch_fft import ref
from repro_torch.kernels.monarch_fft.ops import (MONARCH_CONV_MAX_N2,
                                                 MONARCH_MAX_N2, card_limits,
                                                 monarch, monarch_conv,
                                                 monarch_conv_plan,
                                                 monarch_plan)
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
    and N2 = 2048 / 4096, where only the 16-row N1 block fits shared
    memory."""
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


# shape -> (bm, chunks) the plan picks: every block and slab form of the
# pass; N1 / bm = 1, 2, 4; one CTA for each of the 132 SMs; the N2 limit
PASS_PLANS = {(16, 1024, 1024): (64, 4), (16, 256, 256): (64, 1),
              (132, 64, 128): (64, 1), (66, 128, 256): (64, 1),
              (2, 128, 2048): (32, 8), (1, 128, 1664): (32, 1),
              (1, 64, 4096): (16, 8), (1, 64, MONARCH_MAX_N2): (16, 1)}
# shape -> the conv's plans (monarch_conv_plan): the one front launch
# (bm, chunks) and None, or the two passes'. Every block and slab form of
# each of its kernels; N1 / bm = 32; N1 % 128 == 64 on a grid past one
# wave (the front all the same); the second pass at N2 = N1 = 5888; the
# conv's N2 limit
CONV_PLANS = {(16, 1024, 1024): ((64, 4), (64, 4)),
              (16, 256, 256): ((32, 1), None),
              (4, 1024, 1024): ((32, 8), None),
              (2, 128, 2048): ((16, 8), None),
              (1, 128, MONARCH_CONV_MAX_N2): ((16, 1), None),
              (16, 320, 256): ((32, 1), None),
              (16, 1024, 256): ((64, 1), (64, 4)),
              (8, 512, 2048): ((32, 8), (64, 4)),
              (8, 512, 2304): ((32, 1), (64, 4)),
              (16, 640, 256): ((64, 1), (64, 1)),
              (4, 2048, 256): ((64, 1), (32, 8)),
              (4, 1664, 256): ((64, 1), (32, 1)),
              (2, 4096, 256): ((64, 1), (16, 8)),
              (2, 5888, 128): ((64, 1), (16, 1))}


def _form(p):
    return None if p is None else (p.bm, p.chunks)


def test_every_plan_matches_plain(dev):
    """Each (bm, slab) the plans can pick on this card, both showcase
    shapes among them, against the plain versions."""
    sms, smem = card_limits("monarch_conv_fused",
                            torch.cuda.current_device())
    for (B, N1, N2), want in PASS_PLANS.items():
        p = monarch_plan(B, N1, N2, smem)
        assert _form(p) == want, (B, N1, N2, p)
        m_args, _ = make_inputs(B, N1, N2, dev, seed=N1 + N2)
        _check(f"monarch {(B, N1, N2)} {p}", monarch(*m_args),
               ref.monarch_ref(*m_args))
    for (B, N1, N2), want in CONV_PLANS.items():
        plans = monarch_conv_plan(B, N1, N2, sms, smem)
        assert tuple(map(_form, plans)) == want, (B, N1, N2, plans)
        m_args, c_args = make_inputs(B, N1, N2, dev, seed=N1 + N2)
        _check(f"monarch_conv {(B, N1, N2)} {plans}",
               monarch_conv(*m_args, *c_args),
               ref.monarch_conv_ref(*m_args, *c_args))


def test_interleaved_calls_repeat_bit_for_bit(dev):
    """Calls at other shapes and plans between two calls at one shape
    change nothing: no barrier phase or tile carries from a call into the
    next."""
    shapes = ((16, 1024, 1024), (66, 128, 256), (16, 256, 256),
              (4, 1024, 1024), (16, 1024, 256))
    inputs = {s: make_inputs(*s, dev, seed=sum(s)) for s in shapes}
    first = {s: (monarch(*m), monarch_conv(*m, *c))
             for s, (m, c) in inputs.items()}
    for s in reversed(shapes):
        m, c = inputs[s]
        again = (monarch(*m), monarch_conv(*m, *c))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first[s], again)), s


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

"""How the Monarch kernels tile a shape (``monarch_plan`` in
``repro_torch.kernels.monarch_fft.ops``), on the host: the CUDA kernels
take the plan as it is and check it against the same shared-memory sum
(``monarch_core.cuh``), so what holds here holds for their launches.

At the card tests' shapes, both showcase shapes and N2 up to both limits,
on an H100 SXM (132 SMs, 227 KB of shared memory a block): the N1 blocks
cover N1 exactly, the slab divides the chunk pairs, the ring has at least
three stages wherever any block leaves room for them, and the shared
memory fits; the conv runs as two passes exactly where
``monarch_conv_plan`` says they apply, which follows the card's SM count.
``monarch_l2_bytes`` models each launch's reads from L2 at the showcase
shape.

This file imports no JAX: the plan has no counterpart there.
"""
import pytest

from repro_torch.kernels.monarch_fft.ops import (MONARCH_CONV_MAX_N2,
                                                 MONARCH_MAX_N2,
                                                 monarch_conv_plan,
                                                 monarch_l2_bytes,
                                                 monarch_plan, monarch_smem)

CARD_SHAPES = ((2, 128, 256), (1, 256, 128), (3, 128, 128), (2, 128, 128),
               (16, 1024, 1024), (7, 384, 640), (2, 128, 2048),
               (1, 64, 4096), (132, 64, 128), (66, 128, 256),
               (16, 256, 256), (1, 128, 1664), (1, 128, 2304),
               (4, 1024, 1024), (16, 320, 256), (16, 1024, 256),
               (8, 512, 2048), (8, 512, 2304), (16, 640, 256),
               (4, 2048, 256), (4, 1664, 256), (2, 4096, 256),
               (2, 5888, 128))
LIMIT_SHAPES = tuple((B, N1, n2) for B, N1 in ((1, 64), (16, 1024), (3, 384))
                     for n2 in range(128, MONARCH_MAX_N2 + 1, 128))


# an H100 SXM's SMs and the opt-in shared memory of one block
SMS, SMEM = 132, 232448


def _shapes(conv):
    limit = MONARCH_CONV_MAX_N2 if conv else MONARCH_MAX_N2
    return [s for s in CARD_SHAPES + LIMIT_SHAPES if s[2] <= limit]


@pytest.mark.parametrize("conv", [False, True], ids=["pass", "conv"])
def test_plan_covers_and_fits(conv):
    for B, N1, N2 in _shapes(conv):
        p = monarch_plan(B, N1, N2, SMEM, conv=conv)
        assert p.bm in ((32, 16) if conv else (64, 32, 16))
        assert p.bm * (N1 // p.bm) == N1 and p.ctas == B * N1 // p.bm
        assert p.chunks in (1, 4 if p.bm == 64 else 8)
        assert (N2 // 128) % p.chunks == 0
        assert p.smem == monarch_smem(p.bm, p.stages, N2, conv)
        assert p.smem <= SMEM
        # three stages wherever the smallest block leaves room for them
        room = monarch_smem(16, 3, N2, conv) <= SMEM
        assert p.stages >= (3 if room else 2), (B, N1, N2, p)


def test_plan_takes_both_limits_and_no_more():
    """N2 up to both limits is accepted; past the conv's, its plan finds
    no block that fits."""
    assert monarch_plan(1, 64, MONARCH_MAX_N2, SMEM).bm == 16
    assert monarch_plan(1, 64, MONARCH_CONV_MAX_N2, SMEM, conv=True).bm == 16
    with pytest.raises(ValueError):
        monarch_plan(1, 64, 2 * MONARCH_MAX_N2, SMEM, conv=True)


def test_showcase_plans_and_l2_bytes():
    """At (16, 1024, 1024): the pass in 64-row blocks, phase 1 in two
    slabs, 256 CTAs; the conv as two such passes, the first with the
    filter. Modelled L2 reads a call, each CTA reading x[b] and W1 (4 MiB),
    W0[blk] twice and tw[blk] once: the pass 1.17 GB; the conv's forward
    pass 1.21 GB (its filter tiles too) and inverse pass 1.17 GB, where its
    one-front form would read 3.36 GB in its first launch and 0.537 GB in
    its back GEMM."""
    p = monarch_plan(16, 1024, 1024, SMEM)
    assert (p.bm, p.stages, p.chunks, p.ctas) == (64, 5, 4, 256)
    pass_bytes = 256 * (4 * 2 ** 20 + (2 * 128 + 128) * 2 ** 10)
    assert monarch_l2_bytes(16, 1024, 1024, p)["pass"] == pass_bytes
    fwd, inv = monarch_conv_plan(16, 1024, 1024, SMS, SMEM)
    assert fwd == inv == p
    l2 = monarch_l2_bytes(16, 1024, 1024, (fwd, inv), conv=True)
    assert l2 == {"forward": pass_bytes + 256 * 128 * 2 ** 10,
                  "inverse": pass_bytes}
    assert l2["forward"] <= 3.36e9 / 2
    c = monarch_plan(16, 1024, 1024, SMEM, conv=True)
    assert (c.bm, c.chunks, c.ctas) == (32, 8, 512)
    front = monarch_l2_bytes(16, 1024, 1024, (c, None), conv=True)
    assert front["front"] == 512 * (6 * 2 ** 20 + 256 * 2 ** 10)
    assert front["back"] == 1024 * 512 * 2 ** 10 <= 0.54e9


def test_conv_form():
    """The conv's two passes where its front's grid passes one wave and
    the second pass can take N2 = N1; else the one front launch."""
    assert monarch_conv_plan(16, 1024, 1024, SMS, SMEM)[1] is not None
    for shape in ((16, 256, 256), (4, 1024, 1024), (16, 320, 256),
                  (1, 6144, 128), (2, 128, 2048)):
        front, none = monarch_conv_plan(*shape, SMS, SMEM)
        assert none is None
        assert front == monarch_plan(*shape, SMEM, conv=True)
    for B, N1, N2 in CARD_SHAPES:
        if N2 > MONARCH_CONV_MAX_N2:
            continue
        first, second = monarch_conv_plan(B, N1, N2, SMS, SMEM)
        front = monarch_plan(B, N1, N2, SMEM, conv=True)
        passes = (N1 % 128 == 0 and N1 <= MONARCH_MAX_N2
                  and front.ctas > SMS)
        assert (second is not None) == passes
        if passes:
            assert first == monarch_plan(B, N1, N2, SMEM)
            assert second == monarch_plan(B, N2, N1, SMEM)


def test_plans_follow_the_card():
    """The plans take the card's numbers, not an H100 SXM's: on 114 SMs
    (an H100 PCIe) the 128 front CTAs of (16, 256, 256) pass one wave, so
    the conv runs as two passes; with half the shared memory a block the
    1M-point pass takes 16-row blocks, the largest with three stages, and
    the conv's front fits only at two; with less still nothing fits."""
    assert monarch_conv_plan(16, 256, 256, SMS, SMEM)[1] is None
    assert monarch_conv_plan(16, 256, 256, 114, SMEM)[1] is not None
    half = SMEM // 2
    p = monarch_plan(16, 1024, 1024, half)
    assert (p.bm, p.stages, p.ctas) == (16, 4, 1024) and p.smem <= half
    c = monarch_plan(16, 1024, 1024, half, conv=True)
    assert (c.bm, c.stages) == (16, 2) and c.smem <= half
    with pytest.raises(ValueError):
        monarch_plan(16, 1024, 1024, 64 * 1024)

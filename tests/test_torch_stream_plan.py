"""The FFN kernels' split of a weight over the SMs (``stream_plan`` in
``repro_torch.kernels.fused_decode.ops``), on the host: the CUDA kernel
does the same arithmetic, so what holds here holds for its launch.

For each weight stream of ``oproj_ffn_swiglu`` (out-projection, gate/up,
down-projection) and ``ffn_swiglu`` (gate/up, down) at the 7B widths and at
the card tests' shapes, on 132 SMs (H100 SXM) and 114 (H100 PCIe): every
(column group, k-block) unit is streamed by exactly one CTA, every CTA
streams within one unit's bytes of the mean, and a column group's splits
are the CTAs that hold its units, no more than ``max_splits``.

This file imports no JAX: the plan has no counterpart there.
"""
import pytest

from repro_torch.kernels.fused_decode.ops import (STREAM_GROUP, STREAM_TILE,
                                                  _ffn_layout, stream_plan,
                                                  unit_rows)

# (D, Hq*dh, F): the 7B widths and the card tests' shapes
SHAPES = ((4096, 4096, 11008), (128, 128, 256), (256, 512, 200),
          (128, 520, 328), (512, 512, 1024))


def _streams(D, HD, F):
    """(k, n, weights per unit) of each pass's weight stream."""
    return ((HD, D, 1), (D, F, 2), (F, D, 1))


def _unit_bytes(k, n, nw, u, kblocks):
    g, kb = divmod(u, kblocks)
    rows = min(unit_rows(nw), k - kb * unit_rows(nw))
    cols = min(STREAM_GROUP, n - g * STREAM_GROUP)
    return rows * cols * 2 * nw


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("D,HD,F", SHAPES)
def test_every_unit_once_and_ctas_within_one_unit(D, HD, F, sms):
    for k, n, nw in _streams(D, HD, F):
        p = stream_plan(k, n, sms, nw)
        assert unit_rows(nw) * STREAM_GROUP * 2 * nw == 16 * 1024
        assert p.units == -(-k // unit_rows(nw)) * -(-n // STREAM_GROUP)
        assert p.ctas == min(sms, p.units)
        runs = [range(p.first(c), p.first(c + 1)) for c in range(p.ctas)]
        assert [u for r in runs for u in r] == list(range(p.units))
        assert all(len(r) >= 1 for r in runs)
        for c, r in enumerate(runs):
            assert all(p.owner(u) == c for u in r)
        unit = [_unit_bytes(k, n, nw, u, p.kblocks) for u in range(p.units)]
        assert sum(unit) == k * n * 2 * nw
        mean = sum(unit) / p.ctas
        for r in runs:
            assert abs(sum(unit[u] for u in r) - mean) <= max(unit)
        for g in range(p.groups):
            owners = {p.owner(u) for u in range(g * p.kblocks,
                                                (g + 1) * p.kblocks)}
            assert owners == set(range(min(owners), max(owners) + 1))
            assert p.splits(g) == len(owners) <= p.max_splits


@pytest.mark.parametrize("B", [1, 3, 8, 9, 16])
def test_workspace_regions_are_disjoint(B):
    """The workspace layout the wrapper hands the kernels: counters first
    (one per column group and pass, inside their fixed 64 KB), then y, the
    squares (one per 64-column tile and lane), both activations and the
    partial slots, 256-byte aligned and apart, the last ending at the
    workspace's size."""
    for D, HD, F in SHAPES:
        for hd in (HD, 0):
            nbytes, plan = _ffn_layout(B, D, hd, F, 132)
            f = dict(zip(("B", "D", "HD", "F", "NL", "ctas_o", "maxs_o",
                          "ctas_gu", "maxs_gu", "ctas_dn", "maxs_dn", "y",
                          "ss", "img_g", "img_d", "part_o", "part_gu",
                          "part_dn", "cnt_o", "cnt_gu", "cnt_dn"), plan))
            assert (f["B"], f["D"], f["HD"], f["F"]) == (B, D, hd, F)
            assert f["NL"] == (8 if B <= 8 else 16)
            groups_d, groups_f = (-(-D // STREAM_GROUP),
                                  -(-F // STREAM_GROUP))
            tiles_d = -(-D // STREAM_TILE)
            assert (f["cnt_o"], f["cnt_gu"], f["cnt_dn"]) == (
                0, 4 * groups_d, 4 * (groups_d + groups_f))
            assert f["cnt_dn"] + 4 * groups_d <= 64 * 1024 == f["y"]
            order = ("y", "ss", "img_g", "img_d", "part_o", "part_gu",
                     "part_dn")
            offs = [f[k] for k in order] + [nbytes]
            assert all(o % 256 == 0 for o in offs)
            assert offs == sorted(offs)
            assert f["img_g"] - f["ss"] >= B * tiles_d * 4
            assert f["part_gu"] - f["part_o"] >= (
                groups_d * f["maxs_o"] * 128 * f["NL"] * 4 if hd else 0)

"""The weight streams' split of a weight over the SMs (``stream_plan`` in
``repro_torch.kernels.fused_decode.ops``) and the QKV kernels' column
layout (``qkv_columns``), on the host: the CUDA kernels do the same
arithmetic, so what holds here holds for their launches.

For each weight stream of ``oproj_ffn_swiglu`` (out-projection, gate/up,
down-projection), ``ffn_swiglu`` (gate/up, down) and the QKV kernels
(``qkv_rope_paged``'s three weights, ``qkv_rope``'s one) at the 7B widths
and at the card tests' shapes, on 132 SMs (H100 SXM) and 114 (H100 PCIe):
every (column group, k-block) unit is streamed by exactly one CTA, every
CTA streams within one unit's bytes of the mean, and a column group's
splits are the CTAs that hold its units, no more than ``max_splits``. For
the QKV streams also: every virtual tile is read from the right weight and
column, no padded column is written, and a head's RoPE partners meet in
one column group.

This file imports no JAX: the plan has no counterpart there.
"""
import pytest
import torch

from repro_torch.kernels.fused_decode.ops import (STREAM_GROUP, STREAM_TILE,
                                                  _QKV_PLAN_FIELDS,
                                                  _ffn_layout, _qkv_layout,
                                                  _workspace, qkv_columns,
                                                  qkv_group, stream_plan,
                                                  unit_rows)

# (D, Hq*dh, F): the 7B widths and the card tests' shapes
SHAPES = ((4096, 4096, 11008), (128, 128, 256), (256, 512, 200),
          (128, 520, 328), (512, 512, 1024))


def _streams(D, HD, F):
    """(k, n, weights per unit) of each pass's weight stream."""
    return ((HD, D, 1), (D, F, 2), (F, D, 1))


def _unit_bytes(k, n, nw, u, kblocks, group=STREAM_GROUP):
    g, kb = divmod(u, kblocks)
    rows = min(unit_rows(nw, group), k - kb * unit_rows(nw, group))
    cols = min(group, n - g * group)
    return rows * cols * 2 * nw


def _check_stream(k, n, sms, nw, group=STREAM_GROUP):
    """Every unit once, every CTA within one unit of the mean, a column
    group's splits the CTAs that hold its units."""
    p = stream_plan(k, n, sms, nw, group)
    assert unit_rows(nw, group) * group * 2 * nw == 16 * 1024
    assert p.units == -(-k // unit_rows(nw, group)) * -(-n // group)
    assert p.ctas == min(sms, p.units)
    runs = [range(p.first(c), p.first(c + 1)) for c in range(p.ctas)]
    assert [u for r in runs for u in r] == list(range(p.units))
    assert all(len(r) >= 1 for r in runs)
    for c, r in enumerate(runs):
        assert all(p.owner(u) == c for u in r)
    unit = [_unit_bytes(k, n, nw, u, p.kblocks, group)
            for u in range(p.units)]
    assert sum(unit) == k * n * 2 * nw
    mean = sum(unit) / p.ctas
    for r in runs:
        assert abs(sum(unit[u] for u in r) - mean) <= max(unit)
    for g in range(p.groups):
        owners = {p.owner(u) for u in range(g * p.kblocks,
                                            (g + 1) * p.kblocks)}
        assert owners == set(range(min(owners), max(owners) + 1))
        assert p.splits(g) == len(owners) <= p.max_splits
    return p


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("D,HD,F", SHAPES)
def test_every_unit_once_and_ctas_within_one_unit(D, HD, F, sms):
    for k, n, nw in _streams(D, HD, F):
        _check_stream(k, n, sms, nw)


# (D, Hq, Hkv, dh, rope_frac): the 7B widths and the card tests' shapes -
# dh 32 with Hkv 2 (64 columns) and with Hq 3, Hkv 1 (wq and wk padded to
# a tile), dh 64 at half rotation, dh 128 at half rotation, dh 256
QKV_SHAPES = ((4096, 32, 32, 128, 1.0), (128, 4, 2, 32, 1.0),
              (128, 3, 1, 32, 1.0), (512, 8, 2, 64, 0.5),
              (256, 4, 1, 128, 0.5), (512, 4, 1, 256, 1.0),
              (512, 4, 1, 256, 0.5))


@pytest.mark.parametrize("sms", [132, 114])
def test_qkv_stream_tiles_columns_and_rope_partners(sms):
    for D, Hq, Hkv, dh, frac in QKV_SHAPES:
        rot2 = int(dh * frac) // 2
        for separate in (True, False):
            qc = qkv_columns(Hq, Hkv, dh, separate)
            group = qkv_group(dh)
            p = _check_stream(D, qc.cols, sms, 1, group)
            widths = (qc.wq, qc.wkv, qc.wkv)
            written = set()
            for n in range(p.groups * group):
                col = qc.column(n)
                t, m = divmod(n, STREAM_TILE)
                w, c0 = qc.tile_source(t)
                if col is None:
                    # padding: streamed as zeros from past the map's edge
                    # (or past w_qkv's), never written
                    assert c0 + m >= (widths[w] if separate else qc.cols)
                    continue
                s, nl = col
                assert nl < widths[s] and (s, nl) not in written
                written.add((s, nl))
                # the tile's map and column hold this weight column
                assert (w, c0 + m) == ((s, nl) if separate else (0, n))
                e = nl % dh
                if s < 2 and e < 2 * rot2:
                    n2 = n + rot2 if e < rot2 else n - rot2
                    assert n2 // group == n // group
                    assert qc.column(n2) == (s, nl + n2 - n)
            assert written == {(s, c) for s in range(3)
                               for c in range(widths[s])}
            if separate:
                assert qc.k0 % STREAM_TILE == qc.v0 % STREAM_TILE == 0
            else:
                assert (qc.k0, qc.v0) == (Hq * dh, (Hq + Hkv) * dh)


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


def test_qkv_workspace_regions_are_disjoint():
    """The QKV kernels' workspace: counters first (one per column group,
    inside their fixed 64 KB), then the squares, the activation and the
    partial slots, 256-byte aligned and apart, the last ending at the
    workspace's size; a workspace of its own per device and stream, apart
    from the FFN kernels'."""
    for B in (1, 3, 8, 9, 16):
        for D, Hq, Hkv, dh, frac in QKV_SHAPES:
            for separate in (True, False):
                rot2 = int(dh * frac) // 2
                nbytes, plan = _qkv_layout(B, D, Hq, Hkv, dh, rot2, separate,
                                           132)
                f = dict(zip(_QKV_PLAN_FIELDS, plan))
                nl, tw = f["NL"], qkv_group(dh) // STREAM_TILE
                qc = qkv_columns(Hq, Hkv, dh, separate)
                p = stream_plan(D, qc.cols, 132, 1, qkv_group(dh))
                assert (f["B"], f["D"], f["Hq"], f["Hkv"], f["dh"],
                        f["rot2"]) == (B, D, Hq, Hkv, dh, rot2)
                assert nl == (8 if B <= 8 else 16) and f["TW"] == tw
                assert (f["k0"], f["v0"], f["cols"]) == (qc.k0, qc.v0,
                                                         qc.cols)
                assert (f["ctas"], f["maxs"]) == (p.ctas, p.max_splits)
                assert f["cnt"] == 0 and 4 * p.groups <= 64 * 1024
                offs = [f["ss"], f["img"], f["part"], nbytes]
                assert offs[0] == 64 * 1024
                assert all(o % 256 == 0 for o in offs)
                assert offs == sorted(offs)
                assert f["img"] - f["ss"] >= B * -(-D // STREAM_TILE) * 4
                assert f["part"] - f["img"] >= 2 * nl * D * 2
                assert nbytes - f["part"] >= (p.groups * p.max_splits * 128
                                              * tw * nl // 2 * 4)
    x = torch.zeros(1)
    ffn, qkv = _workspace(x, 7, 1024), _workspace(x, 7, 1024, "qkv")
    assert ffn.data_ptr() + 1024 <= qkv.data_ptr() or \
        qkv.data_ptr() + 1024 <= ffn.data_ptr()
    assert _workspace(x, 7, 512, "qkv") is qkv

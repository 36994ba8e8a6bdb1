"""Wrappers of the fused-decode kernels (counterparts of
``repro.kernels.fused_decode.kernel``'s ``qkv_rope_paged``,
``oproj_ffn_swiglu``, ``qkv_rope`` and ``ffn_swiglu``) and the dense-cache
decoder-layer step composed from them (``ops.decoder_layer_step``). CPU
tensors take the plain versions in ``ref.py``; CUDA tensors launch the
hand-written kernels, which take bf16 activations and weights, or the call
raises. ``stream_plan`` is the split of a weight over the SMs that every
one of them streams (``csrc/stream_gemm.cuh``), ``qkv_columns`` the QKV
kernels' column layout."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import decode
from repro_torch.kernels.fused_decode.ref import (ffn_swiglu_ref, layer_step,
                                                  oproj_ffn_swiglu_ref,
                                                  qkv_rope_paged_ref,
                                                  qkv_rope_ref,
                                                  rope_inv_freq)

_QKV_ARGS = [rt.P] * 13
_EPI_ARGS = [rt.P] * 11
_QKV_DENSE_ARGS = [rt.P] * 7 + [rt.I] * 3 + [rt.P]
_FFN_ARGS = [rt.P] * 8 + [rt.I, rt.P]
# the kernels' weight stream (csrc/stream_gemm.cuh)
STREAM_TILE = 64      # output columns per tile (the squares' granularity)
STREAM_GROUP = 128    # output columns per unit: two adjacent tiles, four
                      # for the QKV stream at head_dim 256 (a whole head)
STREAM_UNIT_BYTES = 16 * 1024   # weight bytes per unit
_CONSUMERS = 128      # consumer threads of a CTA: a partial slot's rows
_MAX_LANES = 16       # lanes of one weight stream; more run in slices
_CNT_BYTES = 64 * 1024    # the workspace's counters, at its start
# ffn_passes.cuh::PlanField, in order
_PLAN_FIELDS = ("B", "D", "HD", "F", "NL", "ctas_o", "maxs_o", "ctas_gu",
                "maxs_gu", "ctas_dn", "maxs_dn", "y", "ss", "img_g", "img_d",
                "part_o", "part_gu", "part_dn", "cnt_o", "cnt_gu", "cnt_dn")
# qkv_pass.cuh::QkvPlanField, in order
_QKV_PLAN_FIELDS = ("B", "D", "Hq", "Hkv", "dh", "rot2", "NL", "TW", "k0",
                    "v0", "cols", "ctas", "maxs", "ss", "img", "part", "cnt")


@functools.lru_cache(maxsize=16)
def _inv_freq(dh: int, theta: float, rope_frac: float, device: str):
    return torch.as_tensor(rope_inv_freq(dh, theta, rope_frac), device=device)


def _check_bf16(name, **tensors):
    for k, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            "bf16")


def qkv_rope_paged(x, norm_scale, wq, wk, wv, pos, *, theta=10000.0,
                   rope_frac=1.0):
    """RMSNorm + QKV + per-lane RoPE for the paged decode step.

    x (B,D); wq (D,Hq,dh), wk/wv (D,Hkv,dh) — the native attention layout;
    pos (B,) int32 per-lane positions. Returns q (B,Hq,dh), k, v (B,Hkv,dh)
    in x.dtype, with RoPE on q and k over the first ``int(dh * rope_frac)``
    (even) elements of a head, the rest passed through. On the card this is
    two launches of the hand-written kernel (see its source) per 16 lanes,
    with scratch in a workspace kept per device and stream
    (``_workspace``)."""
    B, D = x.shape
    _, Hq, dh = wq.shape
    Hkv = wk.shape[1]
    if wq.shape[0] != D or wk.shape != (D, Hkv, dh) or wv.shape != wk.shape:
        raise ValueError("qkv_rope_paged: weight shapes do not match x")
    if not rt.on_card(x, norm_scale, wq, wk, wv, pos):
        inv = _inv_freq(dh, float(theta), float(rope_frac), "cpu")
        return qkv_rope_paged_ref(x, norm_scale, wq, wk, wv, pos, inv)
    rt.no_backward("qkv_rope_paged", x, norm_scale, wq, wk, wv)
    _check_bf16("qkv_rope_paged", x=x, norm_scale=norm_scale, wq=wq, wk=wk,
                wv=wv)
    if pos.dtype != torch.int32:
        raise TypeError("qkv_rope_paged: pos must be int32")
    _check_qkv_widths("qkv_rope_paged", D, dh)
    rt.check_contiguous("qkv_rope_paged", x=x, norm_scale=norm_scale, wq=wq,
                        wk=wk, wv=wv, pos=pos)
    fn = rt.bind("qkv_rope_paged", "qkv_rope_paged_bf16", _QKV_ARGS)
    inv = _inv_freq(dh, float(theta), float(rope_frac), str(x.device))
    q = torch.empty((B, Hq, dh), dtype=x.dtype, device=x.device)
    k = torch.empty((B, Hkv, dh), dtype=x.dtype, device=x.device)
    v = torch.empty_like(k)
    if B == 0:
        return q, k, v
    sms, stream = rt.device_sms(x.device.index), rt.stream_ptr(x)
    for b0, b1 in _lane_slices(B):
        nbytes, plan = _qkv_layout(b1 - b0, D, Hq, Hkv, dh, inv.shape[0],
                                   True, sms)
        ws = _workspace(x, stream, nbytes, "qkv")
        rc = fn(x.data_ptr() + 2 * b0 * D, norm_scale.data_ptr(),
                wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                pos.data_ptr() + 4 * b0, inv.data_ptr(),
                q.data_ptr() + 2 * b0 * Hq * dh,
                k.data_ptr() + 2 * b0 * Hkv * dh,
                v.data_ptr() + 2 * b0 * Hkv * dh, ws.data_ptr(),
                ctypes.addressof(plan), stream)
        rt.check_launch("qkv_rope_paged", rc)
    # the partial rotation is counted on its own: no serving path asks for it
    rt.count_launch("qkv_rope_paged" if inv.shape[0] * 2 == dh else
                    "qkv_rope_paged[partial_rope]")
    return q, k, v


def _check_qkv_widths(name: str, D: int, dh: int) -> None:
    if dh not in (32, 64, 128, 256):
        raise ValueError(f"{name}: kernel takes dh in 32/64/128/256, got "
                         f"{dh}")
    if D % 8:
        raise ValueError(f"{name}: kernel needs D a multiple of 8, got {D}")


def unit_rows(n_weights: int, group: int = STREAM_GROUP) -> int:
    """Weight rows per unit of a stream of ``n_weights`` weights and
    ``group`` columns a unit (64 for one weight, 32 for gate/up's two or a
    group of 256): 16 KB of weights a unit."""
    return STREAM_UNIT_BYTES // (n_weights * group * 2)


class StreamPlan(NamedTuple):
    """How one weight stream (``csrc/stream_gemm.cuh``) spreads a (k, n)
    row-major weight over the card: units of a column group (128 output
    columns, two adjacent 64-column tiles whose rows are read back to back;
    or 256) x ``unit_rows`` weight rows, group-major (unit u is column group
    ``u // kblocks``, k-block ``u % kblocks``); CTA c streams units
    ``[first(c), first(c + 1))``, so every CTA gets within one unit of the
    mean; a column group held by several CTAs is summed by its ``splits``
    in CTA order."""
    kblocks: int
    groups: int
    ctas: int
    max_splits: int       # most CTAs that share one column group

    @property
    def units(self) -> int:
        return self.kblocks * self.groups

    def first(self, c: int) -> int:
        return c * self.units // self.ctas

    def owner(self, u: int) -> int:
        """The CTA whose run holds unit ``u``."""
        return ((u + 1) * self.ctas - 1) // self.units

    def splits(self, g: int) -> int:
        """The CTAs that stream a part of column group ``g``."""
        return (self.owner((g + 1) * self.kblocks - 1)
                - self.owner(g * self.kblocks) + 1)


@functools.lru_cache(maxsize=256)
def stream_plan(k: int, n: int, sms: int, n_weights: int = 1,
                group: int = STREAM_GROUP) -> StreamPlan:
    """The weight stream of ``n_weights`` (k, n) weights read together on
    ``sms`` SMs in column groups of ``group``: one CTA per SM, at most one
    per unit. The kernel does the same arithmetic."""
    kblocks = -(-k // unit_rows(n_weights, group))
    groups = -(-n // group)
    ctas = min(sms, kblocks * groups)
    plan = StreamPlan(kblocks, groups, ctas, 1)
    return plan._replace(max_splits=max(plan.splits(g)
                                        for g in range(groups)))


def _lanes(B: int) -> int:
    """The lanes one weight stream is built for (NL): 8 or 16."""
    return 8 if B <= 8 else _MAX_LANES


@functools.lru_cache(maxsize=64)
def _ffn_layout(B: int, D: int, HD: int, F: int, sms: int):
    """(workspace bytes, int64 plan) of one FFN kernel call on ``B`` <= 16
    lanes; ``HD`` 0 for ``ffn_swiglu`` (no out-projection). The workspace:
    the counters (zeroed once, reset by the kernels), y (B, D) f32, the
    per-tile squares (B, D / 64), the gate/up and down activations (2 NL,
    D) and (2 NL, F) bf16 (hi | lo), and each pass's partial slots. The
    counters are one per column group and pass."""
    nl = _lanes(B)
    po = stream_plan(HD, D, sms) if HD else None
    pgu, pdn = stream_plan(D, F, sms, 2), stream_plan(F, D, sms)
    groups_d, tiles_d = pdn.groups, -(-D // STREAM_TILE)
    if 2 * groups_d + pgu.groups > _CNT_BYTES // 4:
        raise ValueError(f"FFN kernels: D={D}, F={F} exceed the counters")
    off, end = {}, _CNT_BYTES

    def region(name, nbytes):
        nonlocal end
        off[name] = end
        end += -(-nbytes // 256) * 256

    # one split's partial of a group per weight, f32: two tiles' fragments
    slot = _CONSUMERS * 2 * (nl // 2) * 4
    region("y", B * D * 4 if HD else 0)
    region("ss", B * tiles_d * 4)
    region("img_g", 2 * nl * D * 2)
    region("img_d", 2 * nl * F * 2)
    region("part_o", po.groups * po.max_splits * slot if HD else 0)
    region("part_gu", pgu.groups * pgu.max_splits * 2 * slot)
    region("part_dn", pdn.groups * pdn.max_splits * slot)
    off.update(cnt_o=0, cnt_gu=4 * groups_d,
               cnt_dn=4 * (groups_d + pgu.groups))
    vals = dict(B=B, D=D, HD=HD, F=F, NL=nl,
                ctas_o=po.ctas if HD else 0,
                maxs_o=po.max_splits if HD else 0,
                ctas_gu=pgu.ctas, maxs_gu=pgu.max_splits,
                ctas_dn=pdn.ctas, maxs_dn=pdn.max_splits, **off)
    plan = (ctypes.c_longlong * len(_PLAN_FIELDS))(
        *(vals[f] for f in _PLAN_FIELDS))
    return end, plan


class QkvColumns(NamedTuple):
    """The QKV kernels' output columns (``csrc/qkv_pass.cuh``): one virtual
    N holding wq's ``wq`` columns from 0, then wk's and v's ``wkv`` each
    from ``k0`` and ``v0``. Where wq, wk and wv are ``separate`` tensors,
    each starts on a whole 64-column tile (columns in between are padding:
    streamed as zeros, never written); else they are w_qkv's columns."""
    wq: int
    wkv: int
    k0: int
    v0: int
    separate: bool

    @property
    def cols(self) -> int:
        return self.v0 + self.wkv

    def column(self, n: int):
        """(weight 0 q / 1 k / 2 v, its column) of virtual column ``n``, or
        None for padding and past the end: the epilogue's arithmetic."""
        s = 0 if n < self.k0 else 1 if n < self.v0 else 2
        nl = n - (0, self.k0, self.v0)[s]
        return (s, nl) if nl < (self.wq if s == 0 else self.wkv) else None

    def tile_source(self, t: int):
        """(tensor map, column) of 64-column tile ``t``: the producer's
        arithmetic (``QkvPass::source``)."""
        n = t * STREAM_TILE
        if not self.separate:
            return 0, n
        s = 0 if n < self.k0 else 1 if n < self.v0 else 2
        return s, n - (0, self.k0, self.v0)[s]


def qkv_columns(Hq: int, Hkv: int, dh: int, separate: bool) -> QkvColumns:
    """The column layout of a QKV call: three weights (``qkv_rope_paged``)
    or one concatenated w_qkv (``qkv_rope``)."""
    tile = lambda n: -(-n // STREAM_TILE) * STREAM_TILE if separate else n
    wq, wkv = Hq * dh, Hkv * dh
    k0 = tile(wq)
    return QkvColumns(wq, wkv, k0, k0 + tile(wkv), separate)


def qkv_group(dh: int) -> int:
    """Columns of a QKV column group: a head with its RoPE partners must lie
    in one, so 256 at dh = 256, else 128."""
    return 256 if dh == 256 else STREAM_GROUP


@functools.lru_cache(maxsize=64)
def _qkv_layout(B: int, D: int, Hq: int, Hkv: int, dh: int, rot2: int,
                separate: bool, sms: int):
    """(workspace bytes, int64 plan) of one QKV kernel call on ``B`` <= 16
    lanes. The workspace: the counters (one per column group, zeroed once,
    reset by the kernel; a fixed region, so that a call of another shape
    never finds its partial sums there), the per-tile squares (B, D / 64),
    the activation (2 NL, D) bf16 (hi | lo) and the partial slots."""
    nl, group = _lanes(B), qkv_group(dh)
    qc = qkv_columns(Hq, Hkv, dh, separate)
    plan = stream_plan(D, qc.cols, sms, 1, group)
    if plan.groups > _CNT_BYTES // 4:
        raise ValueError(f"QKV kernels: {qc.cols} columns exceed the "
                         "counters")
    off, end = {"cnt": 0}, _CNT_BYTES

    def region(name, nbytes):
        nonlocal end
        off[name] = end
        end += -(-nbytes // 256) * 256

    region("ss", B * -(-D // STREAM_TILE) * 4)
    region("img", 2 * nl * D * 2)
    # one split's partial of a group, f32: its tiles' fragments
    region("part", plan.groups * plan.max_splits * _CONSUMERS
           * (group // STREAM_TILE) * (nl // 2) * 4)
    vals = dict(B=B, D=D, Hq=Hq, Hkv=Hkv, dh=dh, rot2=rot2, NL=nl,
                TW=group // STREAM_TILE, k0=qc.k0, v0=qc.v0, cols=qc.cols,
                ctas=plan.ctas, maxs=plan.max_splits, **off)
    return end, (ctypes.c_longlong * len(_QKV_PLAN_FIELDS))(
        *(vals[f] for f in _QKV_PLAN_FIELDS))


_workspaces: dict = {}


def _workspace(x: torch.Tensor, stream: int, nbytes: int,
               kind: str = "ffn") -> torch.Tensor:
    """The workspace of the FFN (``kind`` "ffn") or the QKV kernels
    ("qkv") for ``x``'s device and ``stream``, one each, so that their
    counters never meet: kept between calls (its counters must start at
    zero, and the kernels leave them so), grown, zeroed, when a call needs
    more."""
    key = (x.device.index, stream, kind)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < nbytes:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=x.device)
        _workspaces[key] = ws
    return ws


def _lane_slices(B: int):
    """Row ranges of at most 16 lanes: each is one weight stream (wider
    accumulators spill at 32)."""
    return [(b, min(B, b + _MAX_LANES)) for b in range(0, B, _MAX_LANES)]


def oproj_ffn_swiglu(x, attn_out, w_o, norm_scale, w_gate, w_up, w_down):
    """The decoder-layer epilogue:

        y = x + attn_out @ w_o ;  return y + SwiGLU(RMSNorm(y)) @ w_down

    x (B,D); attn_out (B, Hq*dh); w_o (Hq*dh, D) (the native (Hq,dh,D) ``wo``
    reshaped); w_gate/w_up (D,F); w_down (F,D). Returns (B,D) in x.dtype.
    On the card this is three launches of the hand-written kernel (see its
    source) per 16 lanes, with scratch in a workspace kept per device and
    stream (``_workspace``)."""
    B, D = x.shape
    HD = attn_out.shape[1]
    F = w_gate.shape[1]
    if (w_o.shape != (HD, D) or w_gate.shape != (D, F)
            or w_up.shape != (D, F) or w_down.shape != (F, D)):
        raise ValueError("oproj_ffn_swiglu: weight shapes do not match")
    if not rt.on_card(x, attn_out, w_o, norm_scale, w_gate, w_up, w_down):
        return oproj_ffn_swiglu_ref(x, attn_out, w_o, norm_scale, w_gate,
                                    w_up, w_down)
    rt.no_backward("oproj_ffn_swiglu", x, attn_out, w_o, norm_scale, w_gate,
                   w_up, w_down)
    _check_bf16("oproj_ffn_swiglu", x=x, attn_out=attn_out, w_o=w_o,
                norm_scale=norm_scale, w_gate=w_gate, w_up=w_up,
                w_down=w_down)
    if D % 8 or F % 8 or HD % 8:
        raise ValueError(f"oproj_ffn_swiglu: kernel needs D, F and Hq*dh "
                         f"multiples of 8, got D={D}, F={F}, Hq*dh={HD}")
    rt.check_contiguous("oproj_ffn_swiglu", x=x, attn_out=attn_out, w_o=w_o,
                        norm_scale=norm_scale, w_gate=w_gate, w_up=w_up,
                        w_down=w_down)
    fn = rt.bind("oproj_ffn_swiglu", "oproj_ffn_swiglu_bf16", _EPI_ARGS)
    out = torch.empty_like(x)
    if B == 0:
        return out
    sms, stream = rt.device_sms(x.device.index), rt.stream_ptr(x)
    for b0, b1 in _lane_slices(B):
        nbytes, plan = _ffn_layout(b1 - b0, D, HD, F, sms)
        ws = _workspace(x, stream, nbytes)
        rc = fn(x.data_ptr() + 2 * b0 * D, attn_out.data_ptr() + 2 * b0 * HD,
                w_o.data_ptr(), norm_scale.data_ptr(), w_gate.data_ptr(),
                w_up.data_ptr(), w_down.data_ptr(),
                out.data_ptr() + 2 * b0 * D, ws.data_ptr(),
                ctypes.addressof(plan), stream)
        rt.check_launch("oproj_ffn_swiglu", rc)
    rt.count_launch("oproj_ffn_swiglu")
    return out


# ------------------------------------------------- dense (shared position)
def qkv_rope(x, norm_scale, w_qkv, pos: int, *, n_q, n_kv, dh, theta=10000.0,
             rope_frac=1.0):
    """RMSNorm + QKV + RoPE at one position for the dense-cache decode step.

    x (B,D); w_qkv (D, (n_q+2*n_kv)*dh) = wq|wk|wv; ``pos`` a host int
    shared by the batch. Returns (n_q+2*n_kv, B, dh) in x.dtype, head-major,
    with RoPE on the q and k heads over their first ``int(dh * rope_frac)``
    (even) elements; v heads are not rotated. On the card this is two
    launches of the hand-written kernel (see its source) per 16 lanes, with
    ``qkv_rope_paged``'s workspace."""
    B, D = x.shape
    Ht = n_q + 2 * n_kv
    if w_qkv.shape != (D, Ht * dh):
        raise ValueError(f"qkv_rope: w_qkv {tuple(w_qkv.shape)} is not "
                         f"({D}, {Ht * dh})")
    pos = int(pos)
    if not rt.on_card(x, norm_scale, w_qkv):
        return qkv_rope_ref(x, norm_scale, w_qkv, pos, n_q=n_q, n_kv=n_kv,
                            dh=dh, theta=theta, rope_frac=rope_frac)
    rt.no_backward("qkv_rope", x, norm_scale, w_qkv)
    _check_bf16("qkv_rope", x=x, norm_scale=norm_scale, w_qkv=w_qkv)
    _check_qkv_widths("qkv_rope", D, dh)
    rt.check_contiguous("qkv_rope", x=x, norm_scale=norm_scale, w_qkv=w_qkv)
    fn = rt.bind("qkv_rope", "qkv_rope_bf16", _QKV_DENSE_ARGS)
    inv = _inv_freq(dh, float(theta), float(rope_frac), str(x.device))
    out = torch.empty((Ht, B, dh), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    sms, stream = rt.device_sms(x.device.index), rt.stream_ptr(x)
    for b0, b1 in _lane_slices(B):
        nbytes, plan = _qkv_layout(b1 - b0, D, n_q, n_kv, dh, inv.shape[0],
                                   False, sms)
        ws = _workspace(x, stream, nbytes, "qkv")
        rc = fn(x.data_ptr() + 2 * b0 * D, norm_scale.data_ptr(),
                w_qkv.data_ptr(), inv.data_ptr(), out.data_ptr(),
                ws.data_ptr(), ctypes.addressof(plan), pos, B, b0, stream)
        rt.check_launch("qkv_rope", rc)
    rt.count_launch("qkv_rope")
    return out


def ffn_swiglu(x, norm_scale, w_gate, w_up, w_down, *, residual=True):
    """x + SwiGLU(RMSNorm(x)) @ w_down; with ``residual=False`` only
    SwiGLU(RMSNorm(x)) @ w_down, the tensor-parallel partial form.

    x (B,D); w_gate/w_up (D,F); w_down (F,D). Returns (B,D) in x.dtype. On
    the card this is three launches of the hand-written kernel (see its
    source) per 16 lanes, with ``oproj_ffn_swiglu``'s workspace."""
    B, D = x.shape
    F = w_gate.shape[1]
    if (w_gate.shape != (D, F) or w_up.shape != (D, F)
            or w_down.shape != (F, D)):
        raise ValueError("ffn_swiglu: weight shapes do not match")
    if not rt.on_card(x, norm_scale, w_gate, w_up, w_down):
        return ffn_swiglu_ref(x, norm_scale, w_gate, w_up, w_down,
                              residual=residual)
    rt.no_backward("ffn_swiglu", x, norm_scale, w_gate, w_up, w_down)
    _check_bf16("ffn_swiglu", x=x, norm_scale=norm_scale, w_gate=w_gate,
                w_up=w_up, w_down=w_down)
    if D % 8 or F % 8:
        raise ValueError(f"ffn_swiglu: kernel needs D and F multiples of 8, "
                         f"got D={D}, F={F}")
    rt.check_contiguous("ffn_swiglu", x=x, norm_scale=norm_scale,
                        w_gate=w_gate, w_up=w_up, w_down=w_down)
    fn = rt.bind("ffn_swiglu", "ffn_swiglu_bf16", _FFN_ARGS)
    out = torch.empty_like(x)
    if B == 0:
        return out
    sms, stream = rt.device_sms(x.device.index), rt.stream_ptr(x)
    for b0, b1 in _lane_slices(B):
        nbytes, plan = _ffn_layout(b1 - b0, D, 0, F, sms)
        ws = _workspace(x, stream, nbytes)
        rc = fn(x.data_ptr() + 2 * b0 * D, norm_scale.data_ptr(),
                w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                out.data_ptr() + 2 * b0 * D, ws.data_ptr(),
                ctypes.addressof(plan), int(bool(residual)), stream)
        rt.check_launch("ffn_swiglu", rc)
    # the partial form is counted on its own: the node's TP body launches it
    rt.count_launch("ffn_swiglu" if residual else
                    "ffn_swiglu[residual=False]")
    return out


def decoder_layer_step(x, p, k_cache, v_cache, pos: int, *, n_q, n_kv, dh,
                       theta=10000.0):
    """One decoder layer's decode step against a dense cache, on the
    kernels: ``qkv_rope`` -> K/V written at ``pos`` -> ``decode`` over
    ``pos + 1`` positions -> ``x + o @ w_o`` (a plain ``torch.matmul``, as
    JAX leaves it to XLA) -> ``ffn_swiglu``.

    x (B,D); ``p`` from ``layer_step_params``; caches (B,S,n_kv,dh), written
    in place (JAX donates them) and returned; ``pos`` a host int shared by
    the batch. Returns (y (B,D), k_cache, v_cache)."""
    return layer_step(qkv_rope, decode, ffn_swiglu, x, p, k_cache, v_cache,
                      pos, n_q=n_q, n_kv=n_kv, dh=dh, theta=theta)


def layer_step_params(params, i: int):
    """``decoder_layer_step``'s ``p`` for layer ``i`` of a dense model tree:
    ``attn_norm``, ``w_qkv`` (D, (Hq+2*Hkv)*dh) = wq|wk|wv, ``w_o``
    (Hq*dh, D), ``mlp_norm``, ``w_gate``, ``w_up``, ``w_down``. Every entry
    is a view of the tree except ``w_qkv``, a new tensor (100 MB per layer
    at 7B): build the layers' dicts once per expert and reuse them for
    every step."""
    from repro_torch.models.transformer import layer_params
    lp = layer_params(params, i)
    a = lp["attn"]
    D = a["wq"].shape[0]
    return {"attn_norm": a["norm"]["scale"],
            "w_qkv": torch.cat([a[w].reshape(D, -1)
                                for w in ("wq", "wk", "wv")], dim=1),
            "w_o": a["wo"].reshape(-1, D),
            "mlp_norm": lp["mlp_norm"]["scale"],
            "w_gate": lp["mlp"]["wi_gate"],
            "w_up": lp["mlp"]["wi_up"],
            "w_down": lp["mlp"]["wo"]}

"""Decode-step backends behind one paged-runner seam (counterpart of
``repro.serving.backends``).

  * ``XlaPagedBackend`` — the plain PyTorch counterpart of the JAX package's
    XLA reference body (``xla_paged_extend``; the names are kept so the two
    packages line up): contiguous ``pool[tables]`` gather + masked softmax.
    It is the correctness reference of the fused path; the parity tests
    pass it in as an object, serving never selects it.
  * ``FusedPagedBackend`` — per decoder layer, the three hand-written
    kernels: ``qkv_rope_paged`` -> K/V scatter -> ``decode_paged`` ->
    ``oproj_ffn_swiglu``. On CPU tensors the wrappers run their plain
    versions, which is how the CPU tests drive this path.

Only single-token steps (g = 1, greedy decode) are ported; the g > 1
speculative verify step waits for the speculative slice (``ROADMAP.md``).
Both bodies update the pools in place and return them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig


def _scatter_rows(lengths, active, tables, block: int, scratch_row: int):
    """Pool row and offset of each lane's new token: its table entry at
    ``lengths // block`` (clamped to the table), or the scratch row when the
    lane is inactive."""
    maxb = tables.shape[1]
    blk_idx = torch.clamp(lengths.long() // block, max=maxb - 1)
    rows = torch.gather(tables.long(), 1, blk_idx[:, None])[:, 0]
    rows = torch.where(active, rows, torch.full_like(rows, scratch_row))
    return rows, lengths.long() % block


# ----------------------------------------------------------------------
# Reference body
# ----------------------------------------------------------------------

@torch.inference_mode()
def xla_paged_extend(cfg: ModelConfig, params, pk, pv, tables, lengths,
                     active, tokens, scratch_row: int):
    """Single-token extend step against the paged pool (plain reference).

    pk/pv   (L, rows, block, Hkv, dh) pools (rows include scratch), updated
            in place
    tables  (B, maxb) int32 block tables padded with the scratch row
    lengths (B,) int32 tokens already cached per slot
    active  (B,) bool — inactive lanes scatter their garbage K/V to scratch
    tokens  (B, 1) int inputs at positions ``lengths``
    Returns (logits (B,1,V), pk, pv)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    B, g = tokens.shape
    if g != 1:
        raise NotImplementedError("multi-token verify steps are not ported yet")
    block = pk.shape[2]
    maxb = tables.shape[1]
    S = maxb * block
    Hq, dh = cfg.n_heads, cfg.head_dim
    h = T.embed_tokens(cfg, params, tokens.long())               # (B,1,D)
    positions = lengths.long()[:, None]                           # (B,1)
    rows, off = _scatter_rows(lengths, active, tables, block, scratch_row)
    tl = tables.long()
    kpos = torch.arange(S, device=pk.device)
    mask = kpos[None, :] <= positions                             # (B,S)
    for i in range(cfg.n_layers):
        lp = T.layer_params(params, i)
        p = lp["attn"]
        hn = L.apply_norm(cfg, p["norm"], h)
        q = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", hn, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", hn, p["wv"])
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
        pk[i, rows, off] = k[:, 0].to(pk.dtype)
        pv[i, rows, off] = v[:, 0].to(pv.dtype)
        kc = pk[i][tl].reshape(B, S, *pk.shape[3:])               # (B,S,Hkv,dh)
        vc = pv[i][tl].reshape(B, S, *pv.shape[3:])
        Hkv = kc.shape[2]
        qg = q.reshape(B, Hkv, Hq // Hkv, dh)
        s = torch.einsum("bhgd,bshd->bhgs", qg.float(), kc.float()) \
            / math.sqrt(dh)
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        pa = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgs,bshd->bhgd", pa.to(vc.dtype).float(),
                         vc.float())
        o = o.reshape(B, 1, Hq, dh).to(h.dtype)
        h = h + torch.einsum("bshk,hkd->bsd", o, p["wo"])
        h = T._mlp(cfg, lp["mlp_norm"], lp["mlp"], h)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return T.unembed(cfg, params, h), pk, pv


# ----------------------------------------------------------------------
# Fused body (g = 1): the three hand-written kernels per layer
# ----------------------------------------------------------------------

@torch.inference_mode()
def fused_paged_extend(cfg: ModelConfig, params, pk, pv, tables, lengths,
                       active, tokens, scratch_row: int):
    """Single-token paged extend where every decoder layer runs as
    ``qkv_rope_paged`` -> K/V scatter -> ``decode_paged`` ->
    ``oproj_ffn_swiglu``. Same semantics as ``xla_paged_extend``: a lane
    attends positions ``<= lengths``, i.e. ``len1 = lengths + 1``; inactive
    lanes scatter to the scratch row and compute finite garbage."""
    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.fused_decode.ops import (oproj_ffn_swiglu,
                                                      qkv_rope_paged)
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    B, g = tokens.shape
    if g != 1:
        raise ValueError("fused_paged_extend is the single-token hot path")
    block = pk.shape[2]
    Hq, dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    h = T.embed_tokens(cfg, params, tokens[:, 0].long())          # (B, D)
    pos = lengths.to(torch.int32)
    rows, off = _scatter_rows(lengths, active, tables, block, scratch_row)
    tables = tables.to(torch.int32).contiguous()
    len1 = (pos + 1).contiguous()
    for i in range(cfg.n_layers):
        lp = T.layer_params(params, i)
        p = lp["attn"]
        q, k, v = qkv_rope_paged(h, p["norm"]["scale"], p["wq"], p["wk"],
                                 p["wv"], pos, theta=cfg.rope_theta)
        pk[i, rows, off] = k.to(pk.dtype)
        pv[i, rows, off] = v.to(pv.dtype)
        o = decode_paged(q.to(pk.dtype), pk[i], pv[i], tables, len1)
        h = oproj_ffn_swiglu(h, o.reshape(B, Hq * dh).to(h.dtype),
                             p["wo"].reshape(Hq * dh, D),
                             lp["mlp_norm"]["scale"], lp["mlp"]["wi_gate"],
                             lp["mlp"]["wi_up"], lp["mlp"]["wo"])
    h = L.apply_norm(cfg, params["final_norm"], h)[:, None]      # (B,1,D)
    return T.unembed(cfg, params, h), pk, pv


# bytes per element on the port's main path: bf16 weights, activations and
# K/V pools; f32 RoPE frequencies; int32 positions, tables and len1
_BF16, _F32, _I32 = 2, 4, 4


def kernel_hbm_bytes(cfg: ModelConfig, batch: int, len1: Sequence[int],
                     maxb: int) -> Dict[str, int]:
    """Device-memory bytes each kernel must move in ONE layer of one fused
    g = 1 step: each input read once, each output written once. K/V bytes
    follow each lane's ``len1`` (the positions it attends), not the table
    width."""
    B = batch
    Hq, Hkv, dh, D, F = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.d_model, cfg.d_ff)
    H = Hq + 2 * Hkv
    rot = dh - dh % 2
    qkv = (B * D * _BF16 + D * _BF16 + B * _I32 + rot // 2 * _F32
           + D * H * dh * _BF16 + B * H * dh * _BF16)
    kv_tokens = int(sum(int(n) for n in len1))
    attn = (2 * B * Hq * dh * _BF16                   # q in + o out
            + B * maxb * _I32 + B * _I32              # tables + len1
            + kv_tokens * Hkv * dh * _BF16 * 2)
    epilogue = ((B * D + B * Hq * dh) * _BF16 + D * _BF16
                + (Hq * dh * D + 3 * D * F) * _BF16
                + B * D * _BF16)
    return {"qkv_rope_paged": qkv, "decode_paged": attn,
            "oproj_ffn_swiglu": epilogue}


def kernel_flops(cfg: ModelConfig, batch: int,
                 len1: Sequence[int]) -> Dict[str, int]:
    """Arithmetic of each kernel in one layer of one g = 1 step (2 per
    multiply-add of the products; the elementwise work is negligible)."""
    B = batch
    Hq, Hkv, dh, D, F = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.d_model, cfg.d_ff)
    tokens = int(sum(int(n) for n in len1))
    return {"qkv_rope_paged": 2 * B * D * (Hq + 2 * Hkv) * dh,
            "decode_paged": 4 * tokens * Hq * dh,
            "oproj_ffn_swiglu": 2 * B * (Hq * dh * D + 3 * D * F)}


def dense_kernel_hbm_bytes(cfg: ModelConfig, batch: int,
                           length: int) -> Dict[str, int]:
    """Device-memory bytes each kernel of ``decoder_layer_step`` must move in
    one layer of one dense-cache step at ``length`` attended positions:
    each input read once, each output written once, bf16 activations,
    weights and caches. K/V bytes follow ``length``, not the cache's S;
    ``pos`` and ``length`` are host ints and move nothing."""
    B = batch
    Hq, Hkv, dh, D, F = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.d_model, cfg.d_ff)
    H = Hq + 2 * Hkv
    rot = dh - dh % 2
    qkv = (B * D * _BF16 + D * _BF16 + rot // 2 * _F32
           + D * H * dh * _BF16 + H * B * dh * _BF16)
    attn = (2 * B * Hq * dh * _BF16                   # q in + o out
            + 2 * B * int(length) * Hkv * dh * _BF16)
    ffn = 2 * B * D * _BF16 + D * _BF16 + 3 * D * F * _BF16
    return {"qkv_rope": qkv, "flash_decode": attn, "ffn_swiglu": ffn}


def dense_kernel_flops(cfg: ModelConfig, batch: int,
                       length: int) -> Dict[str, int]:
    """Arithmetic of each kernel of ``decoder_layer_step`` in one layer of
    one dense-cache step (2 per multiply-add of the products)."""
    B = batch
    Hq, Hkv, dh, D, F = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.d_model, cfg.d_ff)
    return {"qkv_rope": 2 * B * D * (Hq + 2 * Hkv) * dh,
            "flash_decode": 4 * B * int(length) * Hq * dh,
            "ffn_swiglu": 2 * B * 3 * D * F}


def attention_pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs a causal prefill of ``seq`` positions attends:
    sum over i of min(i + 1, W), W = seq without a window."""
    W = min(window or seq, seq)
    return W * (W + 1) // 2 + (seq - W) * W


def prefill_attention_flops(batch: int, seq: int, n_q: int, dh: int,
                            window: int = 0) -> int:
    """Arithmetic of one causal ``flash_prefill`` call: q k^T and p v, 2 per
    multiply-add, over the attended pairs only."""
    return 4 * batch * n_q * dh * attention_pairs(seq, window)


def prefill_attention_hbm_bytes(batch: int, seq: int, n_q: int, n_kv: int,
                                dh: int) -> int:
    """Device-memory bytes of one ``flash_prefill`` call: q, k and v read
    once and o written once, bf16."""
    return _BF16 * batch * seq * (2 * n_q + 2 * n_kv) * dh


def lru_scan_hbm_bytes(batch: int, seq: int, d: int) -> int:
    """Device-memory bytes of one ``lru_scan`` call: a and b read once and h
    written once, f32 (two flops per element besides)."""
    return 3 * _F32 * batch * seq * d


def fused_kernel_hbm_bytes(cfg: ModelConfig, batch: int, len1: Sequence[int],
                           maxb: int) -> int:
    """Device-memory bytes the three kernels must move in one fused g = 1
    step over all layers (see ``kernel_hbm_bytes``)."""
    return cfg.n_layers * sum(kernel_hbm_bytes(cfg, batch, len1,
                                               maxb).values())


# ----------------------------------------------------------------------
# Backend objects + the runner
# ----------------------------------------------------------------------

class PagedBackend:
    """One way to execute the paged extend step."""

    name = "?"

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def extend(self, params, pk, pv, tables, lengths, active, tokens,
               scratch_row: int):
        raise NotImplementedError


class XlaPagedBackend(PagedBackend):
    """The plain PyTorch reference step. Serving never picks it by itself:
    a caller that wants it (a parity test) passes the object in."""

    name = "xla"

    def extend(self, params, pk, pv, tables, lengths, active, tokens,
               scratch_row: int):
        return xla_paged_extend(self.cfg, params, pk, pv, tables, lengths,
                                active, tokens, scratch_row)


class FusedPagedBackend(PagedBackend):
    """The hand-written kernels' step (see module docstring)."""

    name = "fused"

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        unsupported = []
        if cfg.n_experts > 0:
            unsupported.append("MoE FFN")
        if cfg.norm != "rms":
            unsupported.append(f"norm={cfg.norm!r}")
        if cfg.act != "swiglu":
            unsupported.append(f"act={cfg.act!r}")
        if cfg.rope_style != "full":
            unsupported.append(f"rope_style={cfg.rope_style!r}")
        if cfg.qkv_bias or cfg.attn_out_bias or cfg.mlp_bias:
            unsupported.append("attention/MLP biases")
        if unsupported:
            raise ValueError(
                "the fused kernels serve the dense RMSNorm/SwiGLU/full-RoPE "
                f"decoder family only; {cfg.name!r} needs "
                f"{', '.join(unsupported)}, which the port does not serve yet")

    def extend(self, params, pk, pv, tables, lengths, active, tokens,
               scratch_row: int):
        return fused_paged_extend(self.cfg, params, pk, pv, tables, lengths,
                                  active, tokens, scratch_row)


def make_backend(backend: Optional[PagedBackend],
                 cfg: ModelConfig) -> PagedBackend:
    """The fused kernels' backend, unless the caller passes a built
    ``PagedBackend``."""
    if backend is None:
        return FusedPagedBackend(cfg)
    if not isinstance(backend, PagedBackend):
        raise TypeError(f"backend must be a PagedBackend or None, got "
                        f"{backend!r}")
    return backend


class PagedDecodeRunner:
    """Paged prefill / extend for one backbone config, shared by every expert
    of the composition (same backbone, paper §II)."""

    def __init__(self, cfg: ModelConfig, scratch_row: int,
                 backend: Optional[PagedBackend] = None):
        if cfg.family != "dense":
            raise ValueError("paged serving supports the dense family only")
        if cfg.sliding_window:
            raise ValueError("paged serving does not support sliding windows")
        self.cfg = cfg
        self.scratch_row = scratch_row
        self.backend = make_backend(backend, cfg)

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @torch.inference_mode()
    def prefill_kv(self, params, tokens):
        """tokens (1,S) -> (last logits (V,), k, v each (L,S,Hkv,dh))."""
        from repro_torch.models import transformer as T
        logits, caches = T.forward(self.cfg, params, {"tokens": tokens},
                                   return_cache=True, last_only=True)
        k, v = caches[-1]
        return logits[0, -1], k[:, 0], v[:, 0]

    def extend(self, params, pk, pv, tables, lengths, active, tokens):
        return self.backend.extend(params, pk, pv, tables, lengths, active,
                                   tokens, self.scratch_row)


def make_runner(cfg: ModelConfig, scratch_row: int,
                backend: Optional[PagedBackend] = None) -> PagedDecodeRunner:
    """The backend-selection seam: a single-device paged runner."""
    return PagedDecodeRunner(cfg, scratch_row, backend=backend)

"""Tensor-parallel expert execution for one socket group (counterpart of
``repro.node.execution``; paper §VI-C).

``TPPagedDecodeRunner`` is a drop-in ``PagedDecodeRunner``: the engine
drives the same ``prefill_kv`` / ``extend`` surface and its packed prefill,
so continuous batching, admission and the weight cache's prefetch work
unchanged per group. What differs is where the math runs:

  * the expert's weights are split over the group's ranks by the
    ``distributed.partitioning`` rules (q heads and the FFN hidden dim; kv
    heads and the vocab where the TP degree divides them), by
    ``place_params``, the group cache's placement callable: one tree of
    contiguous shards a rank, replicated leaves shared;
  * the paged KV pool is head-sharded where the kv heads shard
    (``PagedKVCache.shard_heads``): each rank holds its own KV;
  * every layer runs on the local shards with two reductions (after the
    attention output projection and after the FFN down projection, the
    Megatron pattern the paper's inter-RDU network serves), plus one for
    the vocab-sharded embedding lookup.

**One controller.** One process drives every rank of a group, as JAX's
``shard_map`` does over emulated devices, and the group's sockets share one
device: each rank holds and computes on its own shard there, and each
``psum`` is an explicit sum of the ranks' partials in rank order. The
vocab-sharded lookup is a select by sum: exactly one rank contributes a
non-zero row per token, so the sum is exact. Ranks on distinct devices
would need ``torch.distributed``; the runner refuses them.

Bodies: the plain TP body (any g: decode, a speculative verify, a prefix
hit's suffix) is JAX's ``_tp_paged_extend``; the fused body (g = 1 on the
fused backend, kv heads sharded) runs per rank and layer the hand-written
kernels ``qkv_rope_paged`` at the rank's heads, the K/V scatter into the
rank's pool shard, ``decode_paged``, the o-projection partial as a
``torch.matmul`` (JAX leaves it to XLA too), then reduction #1,
``ffn_swiglu(residual=False)`` at the rank's FFN shard and reduction #2.
Prefill (packed and sequential) runs the same per-rank layer with the
reductions where JAX lets GSPMD partition the forward. A dense variant's
QKV and FFN input biases are sharded with their heads and hidden dim and
added locally; its output biases are replicated and added once, after the
reduction; a tied head is each rank's vocab slice of the token table.

``PrefillWorker`` is a socket group dedicated to prefill (disaggregated
serving); ``make_group_engine`` builds a group's decode engine.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import partitioning as part
from repro_torch.obs import trace
from repro_torch.serving.backends import (PagedBackend, PagedDecodeRunner,
                                         XlaPagedBackend, _scatter_rows)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import PagedKVCache, head_shard


def _reduce(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The group's all-reduce: the ranks' partials summed in rank order."""
    acc = parts[0]
    for y in parts[1:]:
        acc = acc + y
    return acc


class _TPLayout:
    """What a TP group's bodies need to know of the split: the group's
    device and TP degree, and whether the kv heads and the vocab shard."""

    def __init__(self, cfg: ModelConfig, device, tp: int, kv_sharded: bool,
                 vocab_sharded: bool):
        self.cfg = cfg
        self.device = device
        self.tp = tp
        self.kv_sharded = kv_sharded
        self.vocab_sharded = vocab_sharded
        self.hq_local = cfg.n_heads // tp
        self.hkv_local = cfg.n_kv_heads // tp if kv_sharded \
            else cfg.n_kv_heads
        self._kv_index = [self._make_kv_index(r) for r in range(tp)]

    def kv_index(self, r: int) -> torch.Tensor:
        return self._kv_index[r]

    def _make_kv_index(self, r: int) -> torch.Tensor:
        """The local kv head feeding each of rank ``r``'s q heads (GQA):
        global q index -> global kv index, shifted into the rank's shard
        when the pool is head-sharded."""
        cfg = self.cfg
        q_glob = r * self.hq_local + torch.arange(self.hq_local)
        kv_glob = q_glob * cfg.n_kv_heads // cfg.n_heads
        kv = kv_glob - r * self.hkv_local if self.kv_sharded else kv_glob
        return kv.to(self.device)

    def embed(self, ranks, tokens) -> torch.Tensor:
        """Token embeddings; vocab-sharded: each rank looks up the tokens in
        its slice and zeroes the rest, and the sum selects."""
        if not self.vocab_sharded:
            return ranks[0]["embed"]["tok"][tokens]
        parts = []
        for r, p in enumerate(ranks):
            tab = p["embed"]["tok"]
            n = tab.shape[0]
            loc = tokens - r * n
            ok = (loc >= 0) & (loc < n)
            rows = tab[loc.clamp(0, n - 1)]
            parts.append(torch.where(ok[..., None], rows,
                                     torch.zeros((), dtype=tab.dtype,
                                                 device=tab.device)))
        return _reduce(parts)

    def unembed(self, ranks, h) -> torch.Tensor:
        """Logits; vocab-sharded: each rank's columns, concatenated (the
        JAX body returns them vocab-local; here the controller holds all).
        A tied head is each rank's slice of the token table."""
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        h = L.apply_norm(self.cfg, ranks[0]["final_norm"], h)
        if not self.vocab_sharded:
            return T.unembed(self.cfg, ranks[0], h)
        return torch.cat([T.unembed(self.cfg, p, h) for p in ranks], dim=-1)

    def ffn(self, lps, h) -> torch.Tensor:
        """``h`` plus the FFN, its hidden dim split over the ranks (the
        input biases with it): reduction #2 (plain), then the replicated
        output bias, added once."""
        from repro_torch.models import layers as L
        cfg = self.cfg
        hn = L.apply_norm(cfg, lps[0]["mlp_norm"], h)
        y = _reduce([L.ffn_hidden(cfg, lp["mlp"], hn) @ lp["mlp"]["wo"]
                     for lp in lps])
        return h + (y + lps[0]["mlp"]["bo"] if cfg.mlp_bias else y)

    def attention_layer(self, lps, h, positions, attend):
        """``h`` plus the attention block, its heads split over the ranks:
        rank ``r`` projects its q / k / v heads (adding its shard of the
        QKV biases), ``attend(r, q, k, v)`` returns its (B, S, Hq_local,
        dh) output, and the o-projection partials are reduction #1, to
        which the replicated output bias is added once. Returns (h, [(k,
        v) per rank])."""
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        cfg = self.cfg
        parts, kvs = [], []
        for r, lp in enumerate(lps):
            p = lp["attn"]
            hn = L.apply_norm(cfg, p["norm"], h)
            q, k, v = T.qkv_proj(cfg, p, hn, positions)
            o = attend(r, q, k, v).to(h.dtype)
            parts.append(torch.einsum("bshk,hkd->bsd", o, p["wo"]))
            kvs.append((k, v))
        y = _reduce(parts)
        if cfg.attn_out_bias:
            y = y + lps[0]["attn"]["bo"]
        return h + y, kvs

    def select(self, r: int, k, v):
        """K/V at rank ``r``'s q heads where the kv heads replicate (each
        rank's q heads then read their own kv heads of the full set); the
        rank's own heads, GQA-grouped, where they shard."""
        if self.kv_sharded:
            return k, v
        idx = self.kv_index(r)
        return k[:, :, idx], v[:, :, idx]

    def pool_kv(self, kvs):
        """The layer's K/V in the pool's full-head layout: the ranks' heads
        concatenated, or rank 0's where every rank holds them all."""
        if not self.kv_sharded:
            return kvs[0]
        return (torch.cat([k for k, _ in kvs], dim=2),
                torch.cat([v for _, v in kvs], dim=2))


def _layer_params(ranks, i: int):
    from repro_torch.models.transformer import layer_params
    return [layer_params(p, i) for p in ranks]


@torch.inference_mode()
def tp_paged_extend(lay: _TPLayout, ranks, pk, pv, tables, lengths, active,
                    tokens, scratch_row: int):
    """Plain TP body of the g-token paged extend (JAX ``_tp_paged_extend``):
    ``xla_paged_extend`` on the ranks' shards with the two reductions a
    layer. ``pk``/``pv`` are the group pool's (head-sharded where the kv
    heads shard), updated in place. Returns (logits (B,g,V), pk, pv)."""
    cfg = lay.cfg
    B, g = tokens.shape
    block = pk.shape[2]
    maxb = tables.shape[1]
    S = maxb * block
    dh = cfg.head_dim
    dev = lay.device
    h = lay.embed(ranks, tokens.long())                           # (B,g,D)
    positions = (lengths.long()[:, None]
                 + torch.arange(g, device=dev)[None])             # (B,g)
    rows, off = _scatter_rows(positions, active, tables, block, scratch_row)
    tl = tables.long()
    kpos = torch.arange(S, device=dev)
    mask = kpos[None, None, :] <= positions[:, :, None]           # (B,g,S)

    for i in range(cfg.n_layers):
        lps = _layer_params(ranks, i)

        def attend(r, q, k, v):
            if lay.kv_sharded:
                kp, vp = head_shard(pk, r)[i], head_shard(pv, r)[i]
            else:
                kp, vp = pk[i], pv[i]
            if lay.kv_sharded or r == 0:    # a replicated pool: write once
                kp[rows, off] = k.to(kp.dtype)
                vp[rows, off] = v.to(vp.dtype)
            kc = kp[tl].reshape(B, S, *kp.shape[2:])              # (B,S,H,dh)
            vc = vp[tl].reshape(B, S, *vp.shape[2:])
            idx = lay.kv_index(r)
            k_sel, v_sel = kc[:, :, idx], vc[:, :, idx]           # (B,S,Hq_l,dh)
            s = torch.einsum("bqhd,bshd->bhqs", q.float(),
                             k_sel.float()) / math.sqrt(dh)
            s = s.masked_fill(~mask[:, None], float("-inf"))
            pa = torch.softmax(s, dim=-1)
            return torch.einsum("bhqs,bshd->bqhd", pa.to(v_sel.dtype).float(),
                                v_sel.float())

        h, _ = lay.attention_layer(lps, h, positions, attend)
        h = lay.ffn(lps, h)
    return lay.unembed(ranks, h), pk, pv


@torch.inference_mode()
def tp_fused_paged_extend(lay: _TPLayout, ranks, pk, pv, tables, lengths,
                          active, tokens, scratch_row: int):
    """Fused TP body of the single-token step (JAX ``_tp_fused_paged_extend``)
    on a head-sharded pool: per rank and layer ``qkv_rope_paged`` at the
    rank's heads -> K/V scatter into its pool shard -> ``decode_paged`` ->
    the o-projection partial (``torch.matmul``); reduction #1; per rank
    ``ffn_swiglu(residual=False)`` at its FFN shard; reduction #2."""
    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.fused_decode.ops import (ffn_swiglu,
                                                      qkv_rope_paged)

    cfg = lay.cfg
    B, g = tokens.shape
    if g != 1:
        raise ValueError("the fused TP body is the single-token step")
    if not lay.kv_sharded:
        raise ValueError("the fused TP body needs a head-sharded pool")
    block = pk.shape[2]
    D = cfg.d_model
    hd = lay.hq_local * cfg.head_dim
    h = lay.embed(ranks, tokens[:, 0].long())                     # (B, D)
    pos = lengths.to(torch.int32).contiguous()
    rows, off = _scatter_rows(lengths[:, None], active, tables, block,
                              scratch_row)
    rows, off = rows[:, 0], off[:, 0]
    tables = tables.to(torch.int32).contiguous()
    len1 = (pos + 1).contiguous()
    for i in range(cfg.n_layers):
        lps = _layer_params(ranks, i)
        parts = []
        for r, lp in enumerate(lps):
            p = lp["attn"]
            q, k, v = qkv_rope_paged(h, p["norm"]["scale"], p["wq"], p["wk"],
                                     p["wv"], pos, theta=cfg.rope_theta)
            kp, vp = head_shard(pk, r)[i], head_shard(pv, r)[i]
            kp[rows, off] = k.to(kp.dtype)
            vp[rows, off] = v.to(vp.dtype)
            o = decode_paged(q.to(kp.dtype), kp, vp, tables, len1)
            parts.append(torch.matmul(o.reshape(B, hd).to(h.dtype),
                                      p["wo"].reshape(hd, D)))
        h = h + _reduce(parts)                                    # reduce #1
        h = h + _reduce([ffn_swiglu(h, lp["mlp_norm"]["scale"],
                                    lp["mlp"]["wi_gate"], lp["mlp"]["wi_up"],
                                    lp["mlp"]["wo"], residual=False)
                         for lp in lps])                          # reduce #2
    return lay.unembed(ranks, h[:, None]), pk, pv


def tp_packed_prefill_fn(lay: _TPLayout):
    """The TP counterpart of ``serving.prefill.packed_prefill_fn``: the same
    signature, ``f(ranks, tokens (1,S), seg, pos, last_idx) -> (logits
    (P,V), k (L,S,Hkv,dh), v)``, each layer split over the ranks."""
    from repro_torch.serving.prefill import packed_attention

    @torch.inference_mode()
    def forward(ranks, tokens, seg, pos, last_idx):
        h = lay.embed(ranks, tokens)
        ks, vs = [], []
        for i in range(lay.cfg.n_layers):
            lps = _layer_params(ranks, i)

            def attend(r, q, k, v):
                k, v = lay.select(r, k, v)
                return packed_attention(q, k, v, seg)

            h, kvs = lay.attention_layer(lps, h, pos, attend)
            h = lay.ffn(lps, h)
            k, v = lay.pool_kv(kvs)
            ks.append(k[0])
            vs.append(v[0])
        logits = lay.unembed(ranks, h[0][last_idx])               # (P, V)
        return logits, torch.stack(ks), torch.stack(vs)

    return forward


class TPPagedDecodeRunner(PagedDecodeRunner):
    """Paged prefill / extend for one socket group of ``len(devices)``
    ranks on one device. Its params are ``place_params``'s list of per-rank
    trees.

    Requires the q heads and the FFN hidden dim divisible by the TP degree
    (``configs.pad_for_tp``); the kv heads and the vocab shard where they
    divide and replicate otherwise (``distributed.partitioning``). The fused
    backend needs the kv heads sharded."""

    def __init__(self, cfg: ModelConfig, scratch_row: int, devices,
                 backend: Optional[PagedBackend] = None):
        super().__init__(cfg, scratch_row, backend=backend)
        from repro_torch.models import get_model
        devices = [torch.device(d) for d in devices]
        if len(set(devices)) != 1:
            raise ValueError(
                f"a group's sockets must share one device (one controller "
                f"drives its ranks), got {[str(d) for d in devices]}")
        self.tp = len(devices)
        self.shard_dims = part.param_shard_dims(get_model(cfg).param_specs(),
                                                self.tp)
        if self.tp == 1:
            self.layout = _TPLayout(cfg, devices[0], 1, False, False)
            return
        if cfg.n_experts > 0:
            raise ValueError("TP paged extend supports dense FFN only")
        if cfg.n_heads % cfg.n_kv_heads:
            raise ValueError("TP paged extend needs n_heads % n_kv_heads == 0")
        attn, mlp = self.shard_dims["layers"]["attn"], \
            self.shard_dims["layers"]["mlp"]
        if attn["wq"] != 2 or mlp["wo"] != 1:
            raise ValueError(
                f"n_heads={cfg.n_heads} / d_ff={cfg.d_ff} do not shard over "
                f"tp={self.tp}: pad the config with configs.pad_for_tp")
        kv_sharded = attn["wk"] == 2
        if self.backend.name == "fused" and not kv_sharded:
            raise ValueError(
                "the fused TP extend needs a head-sharded pool "
                f"(n_kv_heads={cfg.n_kv_heads} does not shard over "
                f"tp={self.tp}); pass backend=XlaPagedBackend(cfg)")
        self.layout = _TPLayout(cfg, devices[0], self.tp, kv_sharded,
                                self.shard_dims["embed"]["tok"] == 0)

    @property
    def kv_sharded(self) -> bool:
        return self.layout.kv_sharded

    @property
    def vocab_sharded(self) -> bool:
        return self.layout.vocab_sharded

    # -- placement (the group cache's sharding= / gather=) ---------------
    def place_params(self, host_tree) -> List:
        """Host tree -> one tree of device shards a rank: each sharded leaf
        copied whole to the device, then split there into contiguous
        per-rank copies (a device-to-device copy, so the host copy stays one
        asynchronous transfer from pinned memory); replicated leaves are
        shared by the ranks."""
        dev = self.layout.device

        def split(t, dim):
            full = t.to(dev, non_blocking=True)
            if dim is None or self.tp == 1:
                return [full] * self.tp
            n = full.shape[dim] // self.tp
            return [full.narrow(dim, r * n, n).clone(
                memory_format=torch.contiguous_format)
                for r in range(self.tp)]

        shards = _zip_map(split, host_tree, self.shard_dims)
        return [_pick(shards, r) for r in range(self.tp)]

    def gather_params(self, ranks) -> dict:
        """The inverse of ``place_params``: the host-layout tree, on the
        device."""
        def join(parts, dim):
            if dim is None or self.tp == 1:
                return parts[0]
            return torch.cat(parts, dim=dim)

        return _zip_map(join, _transpose(list(ranks)), self.shard_dims)

    # -- the runner surface ------------------------------------------------
    def packed_prefill_runner(self, buckets, max_segments: int):
        from repro_torch.serving.prefill import (PackedPrefillRunner,
                                                 packed_prefill_fn)
        if self.tp == 1:
            base = packed_prefill_fn(self.cfg)
            fn = lambda ranks, *a: base(ranks[0], *a)
        else:
            fn = tp_packed_prefill_fn(self.layout)
        return PackedPrefillRunner(self.cfg, buckets=buckets,
                                   max_segments=max_segments, forward=fn)

    @torch.inference_mode()
    def prefill_kv(self, params, tokens):
        """tokens (1,S) -> (last logits (V,), k, v each (L,S,Hkv,dh)), each
        rank's attention through ``layers.attention`` (``flash_prefill`` at
        the rank's heads on the card)."""
        from repro_torch.models import layers as L
        if self.tp == 1:
            return super().prefill_kv(params[0], tokens)
        lay = self.layout
        S = tokens.shape[1]
        positions = torch.arange(S, device=lay.device)[None]
        h = lay.embed(params, tokens)
        ks, vs = [], []
        for i in range(self.cfg.n_layers):
            lps = _layer_params(params, i)

            def attend(r, q, k, v):
                k, v = lay.select(r, k, v)
                return L.attention(q, k, v, window=self.cfg.sliding_window)

            h, kvs = lay.attention_layer(lps, h, positions, attend)
            h = lay.ffn(lps, h)
            k, v = lay.pool_kv(kvs)
            ks.append(k[0])
            vs.append(v[0])
        logits = lay.unembed(params, h[:, -1:])
        return logits[0, -1], torch.stack(ks), torch.stack(vs)

    def extend(self, params, pk, pv, tables, lengths, active, tokens):
        lay = self.layout
        fused = self.backend.name == "fused" and tokens.shape[1] == 1
        with trace.span("decode_kernel", cat="kernel",
                        backend=self.backend.name, tp=self.tp,
                        batch=tokens.shape[0], g=tokens.shape[1]):
            if fused and lay.kv_sharded:
                return tp_fused_paged_extend(lay, params, pk, pv, tables,
                                             lengths, active, tokens,
                                             self.scratch_row)
            if self.tp == 1:
                return super().extend(params[0], pk, pv, tables, lengths,
                                      active, tokens)
            return tp_paged_extend(lay, params, pk, pv, tables, lengths,
                                   active, tokens, self.scratch_row)


def _zip_map(fn, tree, dims):
    """``fn(leaf, dim)`` over a params tree and its shard-dim tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], dims[k]) for k in tree}
    return fn(tree, dims)


def _pick(tree, r: int):
    """Rank ``r``'s tree out of a tree whose leaves list the ranks'."""
    if isinstance(tree, dict):
        return {k: _pick(v, r) for k, v in tree.items()}
    return tree[r]


def _transpose(ranks):
    """A list of rank trees -> one tree whose leaves list the ranks'."""
    if isinstance(ranks[0], dict):
        return {k: _transpose([r[k] for r in ranks]) for k in ranks[0]}
    return list(ranks)


class PrefillWorker:
    """A socket group dedicated to prefill (disaggregated serving).

    Prefill is compute-bound, decode bandwidth-bound: colocated, every admit
    is a head-of-line stall for the decode batch. A node in disaggregated
    mode (``RDUNode(prefill_groups=N)``) gives prefill groups of their own:
    each worker owns a ``CompositionOfExperts`` cache over the node's shared
    store, the TP packed prefill on its ranks, and a small paged pool that
    holds K/V only between the packed scatter and the handoff. ``step()``
    packs the queue head's same-expert requests into one bucketed call,
    gathers each request's K/V out of the pool onto the host and attaches it
    as a ``PrefillHandoff``; the node forwards the request to a decode
    group, whose engine adopts the K/V without a forward."""

    def __init__(self, group, coe, cfg: ModelConfig, *,
                 max_len: int = 4096, block_size: int = 16,
                 n_pack: int = 8, buckets=None, kv_dtype=torch.bfloat16,
                 registry=None, labels=None):
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.serving.prefill import default_buckets

        self.group = group
        self.coe = coe
        self.cfg = cfg
        self.block = block_size
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.labels = dict(labels or {})
        buckets = tuple(buckets) if buckets else default_buckets(max_len)
        # staging pool: one packed bucket in flight at a time, so the cap is
        # the largest bucket's blocks + a block of rounding a request +
        # scratch
        n_blocks = -(-buckets[-1] // block_size) + n_pack
        self.pool = PagedKVCache(n_blocks, block_size, cfg.n_layers,
                                 cfg.n_kv_heads, cfg.head_dim, kv_dtype,
                                 scratch=True, device=group.device,
                                 registry=self.registry, labels=self.labels)
        # the group's split mirrors make_group_engine's; the worker never
        # decodes, so it takes the plain backend (no fused-shape checks)
        placer = TPPagedDecodeRunner(cfg, self.pool.scratch_index,
                                     group.devices,
                                     backend=XlaPagedBackend(cfg))
        if placer.kv_sharded:
            self.pool.shard_heads(placer.tp)
        coe.cache.sharding = placer.place_params
        coe.cache.gather = placer.gather_params
        self.runner = placer.packed_prefill_runner(buckets, n_pack)
        self.queue = []
        self.prefilled = 0
        self._ttft_hist = self.registry.histogram("serve.ttft_s",
                                                  labels=self.labels)
        self._handoff_bytes = self.registry.counter("node.kv_handoff_bytes",
                                                    labels=self.labels)
        self._handoffs = self.registry.counter("node.kv_handoffs",
                                               labels=self.labels)

    @property
    def load(self) -> int:
        return len(self.queue)

    @property
    def has_work(self) -> bool:
        return bool(self.queue)

    def submit(self, req):
        if len(req.tokens) > self.runner.buckets[-1]:
            raise ValueError(
                f"request {req.rid}: {len(req.tokens)} prompt tokens exceed "
                f"the prefill group's largest bucket "
                f"{self.runner.buckets[-1]}")
        self.queue.append(req)

    def warmup(self, expert=None):
        """Pay every bucket's first launches against this group's placed
        params and pool."""
        names = self.coe.expert_names()
        if not names:
            raise RuntimeError("prefill worker warmup: no experts registered")
        params = self.coe.cache.activate(expert or names[0])
        self.runner.warmup(params, self.pool)

    def step(self):
        """Prefill one packed batch: the queue head's expert, same-expert
        requests packed FIFO until the largest bucket (or ``n_pack``) fills.
        Returns the completed requests, each carrying a ``PrefillHandoff``."""
        from repro_torch.serving.prefill import PrefillHandoff

        if not self.queue:
            return []
        expert = self.queue[0].expert
        cap = self.runner.buckets[-1]
        picked, rest, total = [], [], 0
        for r in self.queue:
            n = len(r.tokens)
            if (r.expert == expert and len(picked) < self.runner.max_segments
                    and total + n <= cap):
                picked.append(r)
                total += n
            else:
                rest.append(r)
        self.queue = rest
        params = self.coe.cache.activate(expert)
        with trace.span("prefill", cat="node", group=self.group.gid,
                        expert=expert, prompt_tokens=total,
                        **{"prefill.packed": len(picked)}) as sp:
            res = self.runner(params, [r.tokens for r in picked])
            sp.add(**{"prefill.bucket": res.bucket})
            firsts = torch.argmax(res.logits[:len(picked)],
                                  dim=-1).cpu().numpy()
            self.runner.scatter_into(self.pool, res,
                                     [r.rid for r in picked])
        out = []
        for i, r in enumerate(picked):
            with trace.span("kv_handoff", cat="node", group=self.group.gid,
                            request_id=r.rid):
                k, v = self.pool.gather(r.rid)
                # the handoff crosses the inter-socket fabric: it lands on
                # the host, and the staging blocks are released
                hk, hv = k.cpu(), v.cpu()
                self.pool.free(r.rid)
            r.handoff = PrefillHandoff(first_token=int(firsts[i]), k=hk, v=hv)
            now = time.perf_counter()
            r.prefill_done_s = now
            r.first_token_s = now
            self._ttft_hist.observe(now - r.arrival_s)
            self._handoff_bytes.inc(r.handoff.nbytes())
            self._handoffs.inc()
            self.prefilled += 1
            out.append(r)
        return out


def make_group_engine(coe, cfg: ModelConfig, group,
                      **engine_kwargs) -> ServingEngine:
    """A ``ServingEngine`` whose runner executes tensor-parallel on one
    socket group and whose paged pool is head-sharded over its ranks where
    the kv heads shard; the group's weight cache installs placed trees."""
    eng = ServingEngine(
        coe, cfg, device=group.device,
        runner_factory=lambda c, s, backend=None: TPPagedDecodeRunner(
            c, s, group.devices, backend=backend),
        **engine_kwargs)
    if eng.runner.kv_sharded:
        eng.pool.shard_heads(eng.runner.tp)
    coe.cache.sharding = eng.runner.place_params
    coe.cache.gather = eng.runner.gather_params
    return eng

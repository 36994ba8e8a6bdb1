"""Speculative decoding, the standalone dense-cache reference (counterpart
of ``repro.serving.speculative``; paper §VI-B).

Greedy draft-verify: a cheap draft model proposes ``gamma`` tokens one at a
time; the target scores all of them in ONE ``extend_step`` against its dense
cache; the longest matching prefix is accepted plus one corrected token from
the target. With greedy acceptance the output is the target's own greedy
decode, token for token. The serving engine's policy
(``engine.SpeculativeDecode``) runs the same algorithm on the paged slots.

On the card: both prefills run ``flash_prefill`` (``layers.attention``);
each draft step is ``decode_step``'s arithmetic composed from
``decoder_layer_step`` (the kernels ``qkv_rope``, ``flash_decode`` and
``ffn_swiglu``; their plain versions on the CPU); the verify runs
``layers.naive_attention`` at ``q_offset=pos``, plain, as JAX's runs in XLA.
A draft the kernels do not compute (``backends.kernel_refusals``: biases, a
LayerNorm, GELU, a RoPE variant) is refused unless the caller passes
``draft_kernels=False``: its steps are then the model's plain
``decode_step``, JAX's draft body.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


@torch.no_grad()
def extend_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """Multi-token cache-attending step: tokens (B,g) at positions
    ``pos .. pos+g-1`` (a host int shared by the batch), written into the
    dense cache in place. Returns (logits (B,g,V), cache). Dense and moe
    families (an MoE verify's capacity counts the B * g tokens).

    Under a sliding window the cache is a ring of S positions and the step
    writes at ``pos % S``, as JAX's does; it is the identity while ``pos +
    g <= S``. A verify that would wrap the ring is refused: JAX's clamps
    its write there (``dynamic_update_slice``) and attends ring indices as
    positions, which is no window attention."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError("speculative verify: dense/moe only")
    B, g = tokens.shape
    pos = int(pos)
    S = cache["k"].shape[2]
    if cfg.sliding_window and pos + g > S:
        raise ValueError(
            f"speculative verify of {g} tokens at position {pos} would wrap "
            f"the {S}-position window ring; the verify attends ring indices "
            "as positions, so it stops at the ring's end (ROADMAP.md, "
            "Differences from JAX)")
    h = T.embed_tokens(cfg, params, tokens.long())
    positions = (pos + torch.arange(g, device=h.device))[None].expand(B, g)
    for i in range(cfg.n_layers):
        lp = T.layer_params(params, i)
        p = lp["attn"]
        hn = L.apply_norm(cfg, p["norm"], h)
        q, k, v = T.qkv_proj(cfg, p, hn, positions)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos:pos + g] = k.to(kc.dtype)
        vc[:, pos:pos + g] = v.to(vc.dtype)
        # verify attention: g queries at offset pos against the whole cache
        o = L.naive_attention(q, kc, vc, causal=True, q_offset=pos)
        h = h + T.attn_out(cfg, p, o.to(h.dtype))
        h = T._mlp(cfg, lp["mlp_norm"], lp["mlp"], h)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return T.unembed(cfg, params, h), cache


@torch.no_grad()
def draft_step(cfg: ModelConfig, params, layers, cache, tokens, pos: int):
    """One greedy decode step of the draft: ``decode_step``'s arithmetic as
    ``decoder_layer_step`` per layer (``layers`` from ``layer_step_params``,
    built once), or, with ``layers`` None, the model's plain
    ``decode_step``. tokens (B,1) at the host int ``pos``; the cache is
    written in place. Returns (logits (B,V), cache)."""
    from repro_torch.kernels.fused_decode.ops import decoder_layer_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    if layers is None:
        return T.decode_step(cfg, params, cache, tokens.long(), pos)
    kw = dict(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads, dh=cfg.head_dim,
              theta=cfg.rope_theta)
    h = T.embed_tokens(cfg, params, tokens[:, 0].long())
    for i, p in enumerate(layers):
        h, _, _ = decoder_layer_step(h, p, cache["k"][i], cache["v"][i], pos,
                                     **kw)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return T.unembed(cfg, params, h), cache


@dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    target_calls: int = 0
    draft_calls: int = 0

    @property
    def acceptance_rate(self):
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_target_call(self):
        return (self.accepted + self.target_calls) / max(self.target_calls, 1)


class SpeculativeDecoder:
    """Greedy speculative decoding: draft proposes, target verifies."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 gamma: int = 4, draft_kernels: bool = True):
        from repro_torch.serving.backends import kernel_refusals
        assert target_cfg.vocab_size == draft_cfg.vocab_size
        refused = kernel_refusals(draft_cfg)
        if draft_kernels and refused:
            raise ValueError(
                f"the decode kernels do not compute the draft "
                f"{draft_cfg.name!r} ({', '.join(refused)}): pass "
                "draft_kernels=False for the plain decode_step")
        self.draft_kernels = draft_kernels
        self.t_cfg, self.d_cfg = target_cfg, draft_cfg
        self.t_model = get_model(target_cfg)
        self.d_model = get_model(draft_cfg)
        self.gamma = gamma
        self.stats = SpecStats()

    def generate(self, t_params, d_params, prompt: np.ndarray,
                 n_tokens: int) -> np.ndarray:
        """prompt (B,S) -> (B, n_tokens), greedy, on the device the target's
        weights lie on. A round accepts the prefix every row agrees on."""
        from repro_torch.kernels.fused_decode.ops import layer_step_params
        B, S = prompt.shape
        dev = t_params["embed"]["tok"].device
        max_len = S + n_tokens + self.gamma + 2
        jp = torch.as_tensor(np.asarray(prompt), device=dev).long()
        t_last, t_cache = self.t_model.prefill(t_params, {"tokens": jp},
                                               max_len)
        _, d_cache = self.d_model.prefill(d_params, {"tokens": jp}, max_len)
        d_layers = ([layer_step_params(d_params, i)
                     for i in range(self.d_cfg.n_layers)]
                    if self.draft_kernels else None)
        out = np.zeros((B, n_tokens), np.int32)
        cur = torch.argmax(t_last, -1)                     # token at pos S
        out[:, 0] = cur.cpu().numpy()
        n_done = 1
        pos = S                                            # next write pos

        while n_done < n_tokens:
            g = min(self.gamma, n_tokens - n_done)
            # --- draft proposes g tokens autoregressively
            d_tokens = [cur]
            for i in range(g):
                lg, d_cache = draft_step(self.d_cfg, d_params, d_layers,
                                         d_cache, d_tokens[-1][:, None],
                                         pos + i)
                d_tokens.append(torch.argmax(lg, -1))
                self.stats.draft_calls += 1
            prop = torch.stack(d_tokens[:-1], dim=1)       # (B,g) inputs
            draft_next = torch.stack(d_tokens[1:], dim=1)  # (B,g) proposals

            # --- target verifies all g in one pass
            t_logits, t_cache = extend_step(self.t_cfg, t_params, t_cache,
                                            prop, pos)
            self.stats.target_calls += 1
            t_next = torch.argmax(t_logits, -1)            # (B,g)

            match = (draft_next == t_next).cpu().numpy()
            prefix = 0
            for i in range(g):
                if match[:, i].all():
                    prefix += 1
                else:
                    break
            self.stats.proposed += g
            self.stats.accepted += prefix
            # the accepted tokens and, after a mismatch, the target's own
            emit = t_next[:, :min(prefix + 1, g)].cpu().numpy()
            emit = emit[:, : n_tokens - n_done]
            out[:, n_done:n_done + emit.shape[1]] = emit
            n_done += emit.shape[1]
            cur = torch.as_tensor(emit[:, -1], device=dev).long()
            pos += emit.shape[1]
            # the draft cache needs no re-sync: positions past ``pos`` are
            # masked by the next step's length and overwritten
        return out[:, :n_tokens]

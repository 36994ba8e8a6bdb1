"""AdamW with a warmup-cosine schedule and global-norm clipping
(counterpart of ``repro.optim.adamw``), plain PyTorch as JAX's is XLA.

The optimizer state mirrors the param tree: ``{"mu", "nu"}`` f32 trees and
an int32 scalar ``step``. The arithmetic follows JAX's rounding points: the
gradient cast to f32 and scaled by the clip, f32 moments, bias corrections
at ``t = step + 1``, weight decay on the f32 param, the new param cast back
to the param's dtype. Unlike JAX's pure function, the update is made in
place, leaf by leaf (the params and moments of the returned state are the
tensors passed in): a full-size state would not fit twice on one card, and
one leaf's f32 temporaries at a time is what the update keeps alive.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.bridge import tree_items, tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int scalar tensor) as an f32
    scalar: linear warmup over ``warmup_steps``, then a cosine from ``lr``
    to ``lr * min_lr_ratio`` at ``decay_steps``."""
    s = step.to(torch.float32)
    warm = cfg.lr * torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(s < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params):
    """f32 zeros shaped as each param, on its device, and step 0 (int32, on
    the first leaf's device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32
    (each leaf's norm taken in f32 without an f32 copy of the leaf). A
    DTensor leaf's norm is the whole tensor's: DTensor reduces its shards'
    partial norms over the mesh before the square, so every rank gets the
    global norm and clips alike."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.linalg.vector_norm(x, dtype=torch.float32).square()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (new_params, new_opt_state, metrics) with metrics ``lr`` and
    ``grad_norm`` (f32 scalars). ``grads`` has the params' structure; a
    ``None`` leaf is a zero gradient (JAX's grad of an unused leaf). Params,
    ``mu`` and ``nu`` are updated in place and returned; ``step`` is a new
    tensor."""
    step = opt_state["step"]
    p_of, g_of = dict(tree_items(params)), dict(tree_items(grads))
    names = sorted(p_of)                 # JAX's leaf order
    mu_of = dict(tree_items(opt_state["mu"]))
    nu_of = dict(tree_items(opt_state["nu"]))
    present = [g_of[n] for n in names if g_of.get(n) is not None]
    gnorm = global_norm(present) if present else \
        torch.zeros((), dtype=torch.float32, device=step.device)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)
    for n in names:
        p, mu, nu, g = p_of[n], mu_of[n], nu_of[n], g_of.get(n)
        if g is None:
            g32 = torch.zeros_like(mu)
        else:
            g32 = g.to(torch.float32) * scale
        mu.mul_(b1).add_(g32, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        delta = mu / bc1
        delta.div_((nu / bc2).sqrt_().add_(cfg.eps))
        p32 = p.to(torch.float32)
        delta.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(delta.mul_(lr))         # p itself where p is f32
        if p32 is not p:
            p.copy_(p32)
        del delta, p32
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"],
                 "step": step + 1}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


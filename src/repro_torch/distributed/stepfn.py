"""The train step (counterpart of ``repro.distributed.stepfn``'s loss and
``make_train_step``) on one device: no mesh, no shardings, no jit. The
mesh-sharded train, prefill and decode builders come with distribution
(ROADMAP.md, Queue 1).

The state is ``{"params", "opt": {"mu", "nu", "step"}}``; a step takes the
gradient of the mean token cross-entropy of ``model.forward(params, batch,
remat=remat)`` by autograd and applies ``optim.adamw_update``, which
updates the params and moments in place (see ``optim.adamw``). On the card
the forward's attention runs the ``flash_prefill`` kernel's LSE form and
its backward the ``flash_prefill_bwd`` kernels (``kernels.flash_attention.
ops.FlashAttention``); a kernel with no backward raises under grad instead
of leaving the weights upstream without a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.bridge import tree_from_items, tree_items
from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state


def softmax_xent(logits, targets):
    """Mean token cross-entropy; f32 logsumexp."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def chunked_xent(cfg, model, params, h_fn, batch, n_chunks=8):
    """Cross-entropy without the full (B,S,V) logits at once: the final
    hidden states are unembedded and reduced a sequence chunk at a time."""
    from repro_torch.models import transformer as T
    h = h_fn()
    B, S, D = h.shape
    c = S // n_chunks
    total = 0.0
    for i in range(n_chunks):
        hs = h[:, i * c:(i + 1) * c]
        ts = batch["targets"][:, i * c:(i + 1) * c]
        lf = T.unembed(cfg, params, hs).float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, ts[..., None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (B * S)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, remat: bool = True, accum_steps: int = 1):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    batch = {'tokens': (B,S), 'targets': (B,S)[, 'enc_embeds': ...]}, on
    the params' device. metrics: ``loss``, ``lr``, ``grad_norm`` (f32
    scalar tensors). With ``accum_steps`` > 1 the batch splits into
    microbatches along dim 0 and their gradients are summed in f32, then
    divided by ``accum_steps`` before one optimizer step, as JAX's scan
    does. A param no loss reaches gets a zero gradient."""
    model = get_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig()

    def loss_and_grads(params, batch):
        names, leaves = zip(*tree_items(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                logits = model.forward(params, batch, remat=remat)
                loss = softmax_xent(logits, batch["targets"])
                del logits
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), dict(zip(names, grads))

    def step_fn(state, batch):
        params = state["params"]
        if accum_steps <= 1:
            loss, flat = loss_and_grads(params, batch)
        else:
            micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                     for i in range(accum_steps)]
            loss, flat = 0.0, dict.fromkeys(n for n, _ in tree_items(params))
            for mb in micro:
                l, g = loss_and_grads(params, mb)
                loss = loss + l
                for n, x in g.items():
                    if x is not None:
                        flat[n] = x.float() if flat[n] is None \
                            else flat[n].add_(x.float())
                del g
            loss = loss / accum_steps
            flat = {n: None if x is None else x.div_(accum_steps)
                    for n, x in flat.items()}
        grads = tree_from_items(params, flat)
        del flat
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, params, grads, state["opt"])
        metrics = dict(metrics, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return step_fn


def init_train_state(params):
    """``{"params": params, "opt": init_opt_state(params)}``."""
    return {"params": params, "opt": init_opt_state(params)}

"""Training driver of the port: ``python -m repro_torch.launch.train --arch
<id> [...]`` (counterpart of ``repro.launch.train``).

Deterministic resumable data (``data``), the single-device train step
(``distributed.stepfn``: AdamW, remat), atomic checkpoints in the JAX
package's format (``checkpoint``). On the card (``--device cuda``, the
default) the dense and moe families train, their attention through the
``flash_prefill`` kernel's LSE form and its backward kernel; a family
whose kernels have no backward (RecurrentGemma's ``lru_scan``, MLA's
(192, 128) widths, Whisper's full attention) raises there instead of
training without gradients. ``--device cpu --reduced``
runs any family on the plain versions:

    python -m repro_torch.launch.train --arch samba-coe-expert-7b \\
        --reduced --device cpu --steps 6

``--mesh`` takes only ``1x1``: distribution is ROADMAP.md's next item.
Weights are random, drawn from seed 0 on the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, make_source
from repro_torch.distributed import stepfn
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig


def to_device(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--mesh", default="1x1",
                    help="only '1x1': one device (distribution is "
                         "ROADMAP.md's next item)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise ValueError(
            f"--mesh {args.mesh}: the port trains on one device; meshes "
            "come with distribution (ROADMAP.md, Queue 1: distributed/"
            "{ctx,pipeline,compression}.py and launch/mesh.py)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = get_model(cfg)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          decay_steps=max(4, args.steps))
    step_fn = stepfn.make_train_step(cfg, opt_cfg)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    source = make_source(data_cfg)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    state = stepfn.init_train_state(params)
    if ckpt and args.resume:
        restored, start = ckpt.restore_state(state, dev)
        if restored is not None:
            state = restored
            print(f"resumed at step {start}")

    losses = []
    for step in range(start, args.steps):
        batch = source.batch_at(step)
        if cfg.family == "encdec":
            batch = dict(batch)
            batch["enc_embeds"] = np.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model), np.float32)
        tb = to_device(batch, dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tb)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        print(f"step {step:5d} loss={loss:.4f} "
              f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(args.steps, state)
    if len(losses) >= 5:
        assert losses[-1] < losses[0], "loss did not decrease"
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} OK")
    return losses


if __name__ == "__main__":
    main()

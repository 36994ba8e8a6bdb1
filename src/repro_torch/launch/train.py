"""Training driver of the port: ``python -m repro_torch.launch.train --arch
<id> [...]`` (counterpart of ``repro.launch.train``).

Deterministic resumable data (``data``), the single-device train step
(``distributed.stepfn``: AdamW, remat), atomic checkpoints in the JAX
package's format (``checkpoint``). On the card (``--device cuda``, the
default) every family trains: attention through the ``flash_prefill``
kernel's LSE form and its backward kernel (causal, windowed or full, at
every head width the kernel takes), RecurrentGemma's recurrence through
``lru_scan`` and its backward kernel. ``--device cpu --reduced`` runs any
family on the plain versions:

    python -m repro_torch.launch.train --arch samba-coe-expert-7b \\
        --reduced --device cpu --steps 6

``--mesh DxM`` (or ``production`` / ``production-multipod``: (16, 16) and
(2, 16, 16)) trains on a ('data', 'model') mesh of D x M ranks, one process
a rank, under ``torchrun``: the config padded for M (``configs.
pad_for_tp``), the mesh train step (``distributed.stepfn``, Megatron-SP
residuals), the state saved whole and restored onto any mesh:

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch samba-coe-expert-7b --reduced --device cpu --mesh 1x2

The group is gloo on the CPU and NCCL on CUDA (a card a rank). ``--mesh
1x1`` without torchrun is the single-device step. Weights are random,
drawn from seed 0 on the device (the same on every rank; each keeps its
shard).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import pad_for_tp
from repro_torch.data import DataConfig, make_source
from repro_torch.distributed import partitioning as part
from repro_torch.distributed import stepfn
from repro_torch.launch import mesh as meshes
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
                    help="tiny same-family config at the family's "
                         "attention heads (CPU-runnable)")
    ap.add_argument("--mesh", default="1x1",
                    help="'1x1' | 'DxM' | 'production' | "
                         "'production-multipod' (all but 1x1 under "
                         "torchrun, one rank a mesh device)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = make_train_mesh(args.mesh, dev)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    tp = part.mesh_axes(mesh).get("model", 1) if mesh is not None else 1
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, full_heads=True)
    cfg = pad_for_tp(cfg, tp)
    model = get_model(cfg)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          decay_steps=max(4, args.steps))
    if mesh is None:
        step_fn = stepfn.make_train_step(cfg, opt_cfg)
    else:
        step_fn, state_sh, batch_sh = stepfn.make_train_step(
            cfg, opt_cfg, mesh=mesh)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    source = make_source(data_cfg)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    state = stepfn.init_train_state(params)
    if mesh is not None:
        state = part.device_put(state, state_sh)
    if ckpt and args.resume:
        restored, start = ckpt.restore_state(
            state, dev, state_sh if mesh is not None else None)
        if restored is not None:
            state = restored
            print(f"resumed at step {start}")
    rank0 = mesh is None or torch.distributed.get_rank() == 0

    losses = []
    for step in range(start, args.steps):
        batch = source.batch_at(step)
        if cfg.family == "encdec":
            batch = dict(batch)
            batch["enc_embeds"] = np.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model), np.float32)
        tb = to_device(batch, dev)
        if mesh is not None:
            tb = part.device_put(tb, batch_sh(tb))
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tb)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        if rank0:
            print(f"step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(args.steps, state)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if len(losses) >= 5:
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"loss did not decrease: {losses}")
        if rank0:
            print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} OK")
    return losses


def make_train_mesh(spec: str, dev: torch.device):
    """None for ``1x1`` outside a process group (the single-device step);
    else the ('data', 'model') mesh ``spec`` names over the group, which
    this starts from torchrun's environment (NCCL on CUDA, a card a local
    rank; gloo on the CPU)."""
    import os
    if "RANK" not in os.environ:
        if spec == "1x1":
            return None
        raise ValueError(f"--mesh {spec}: a mesh runs one process a rank, "
                         "started by torchrun (torchrun --standalone "
                         "--nproc-per-node <ranks> -m repro_torch.launch."
                         "train ...)")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", torch.cuda.current_device())
    meshes.init_distributed(device=dev)
    if spec == "production":
        return meshes.make_production_mesh(device=dev)
    if spec == "production-multipod":
        return meshes.make_production_mesh(multi_pod=True, device=dev)
    d, m = (int(x) for x in spec.split("x"))
    return meshes.make_mesh((d, m), ("data", "model"), device=dev)


if __name__ == "__main__":
    main()

"""Train an expert end-to-end with the PyTorch port (counterpart of
``examples/train_expert.py``): ~100M-parameter dense model, a few hundred
steps with checkpoint/restart (the CoE story: experts are trained /
fine-tuned independently, then registered into the composition).

On the card (the default) every step runs each layer's attention through
``flash_prefill``'s LSE form and its backward kernel. The checkpoints are
in the JAX package's on-disk format, so the default directory is the
port's own: a run never resumes another package's weights by accident.

    PYTHONPATH=src python examples/train_expert_torch.py --steps 200
    PYTHONPATH=src python examples/train_expert_torch.py --device cpu --steps 4 --batch 2 --seq 32
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_source
from repro_torch.distributed import stepfn
from repro_torch.launch.train import to_device
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig

CKPT_EVERY = 100
LOG_EVERY = 20


def expert_config():
    """The ~100M-param llama-style expert."""
    return dataclasses.replace(
        get_config("samba-coe-expert-7b"),
        name="expert-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=1536, vocab_size=32000)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_expert_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def train(cfg, args, device, params=None):
    """Train ``cfg`` from the newest checkpoint under ``args.ckpt`` (or from
    ``params``, else a seed-0 init) up to ``args.steps``, checkpointing
    every ``CKPT_EVERY`` steps and at the end. Returns (state, the losses
    of the steps run as an f32 tensor on the host, the steady step seconds:
    the loop's wall after its first step, checkpoint writes excluded)."""
    model = get_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, decay_steps=args.steps)
    step_fn = stepfn.make_train_step(cfg, opt_cfg)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))
    ckpt = CheckpointManager(args.ckpt, keep=2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0), device)
    state = stepfn.init_train_state(params)
    restored, start = ckpt.restore_state(state, device)
    if restored is not None:
        state = restored
        print(f"resumed from step {start}")
    losses, t0, saving = [], None, 0.0
    for step in range(start, args.steps):
        batch = to_device(source.batch_at(step), device)
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        if t0 is None:
            t0 = sync()
        if step % LOG_EVERY == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e}")
        if (step + 1) % CKPT_EVERY == 0:
            ts = sync()
            ckpt.save(step + 1, state)
            saving += sync() - ts
            print(f"checkpointed step {step+1}")
    steady = sync() - t0 - saving if t0 is not None else 0.0
    ckpt.save(args.steps, state)
    losses = torch.stack(losses).float().cpu() if losses else torch.zeros(0)
    return state, losses, steady


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = expert_config()
    print(f"training {cfg.name}: {cfg.n_params()/1e6:.1f}M params")
    state, losses, steady = train(cfg, args, device)
    if len(losses) > 1:
        n = len(losses) - 1
        print(f"{n} steps after the first in {steady:.2f}s: "
              f"{steady / n * 1e3:.1f} ms a step, "
              f"{n * args.batch * args.seq / steady:.0f} tokens/s")
    print("done — register this expert into a CoE with "
          "examples/coe_serving_torch.py")
    return state, losses, steady


if __name__ == "__main__":
    main()

"""Time the port's training step at ``chip_smoke.py``'s training-phase
shape (``chip_smoke.TRAIN``: samba-coe-expert-7b cut to 8 layers, B 4 x
2048, remat, AdamW) on one card, for comparing two trees of the
repository in one call:

    python tools/train_step_timing.py --src build/parent/src --label parent
    python tools/train_step_timing.py --src src --label tree

``--src`` is the ``src`` directory of the tree under test: its
``repro_torch`` is imported from there and builds its kernels into its
own ``build/``. Weights from seed ``TRAIN["seed"]``, the SyntheticLM batch
of the training phase; ``--steps`` steps, each ended by
``torch.cuda.synchronize()`` on the host clock. Prints one JSON line: the
label, each step's seconds, the median of the steps after the first two,
its tokens/s, the first and last loss, peak device memory, the card and
its power limit."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    from chip_smoke import TRAIN
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import stepfn
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    if not torch.cuda.is_available():
        sys.exit("train_step_timing: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = TRAIN
    cfg = dataclasses.replace(get_config(t["arch"]), n_layers=t["layers"])
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=t["seq"], global_batch=t["batch"],
                                   seed=t["seed"])).batch_at(0)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    params = get_model(cfg).init(
        torch.Generator(dev).manual_seed(t["seed"]), dev)
    fn = stepfn.make_train_step(
        cfg, AdamWConfig(lr=t["lr"], warmup_steps=2, decay_steps=4))
    state = stepfn.init_train_state(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[2:]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "label": args.label, "step_s": walls, "median_s": med,
        "tokens_per_s": t["batch"] * t["seq"] / med,
        "loss_first": losses[0], "loss_last": losses[-1],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": smi}))


if __name__ == "__main__":
    main()

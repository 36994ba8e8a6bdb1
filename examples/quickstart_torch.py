"""Quickstart of the PyTorch port (counterpart of ``examples/quickstart.py``):
build a reduced expert, run forward / prefill / decode, and peek at the
three-tier memory + fusion reports.

On the card (the default) the forward and the prefill run each layer's
attention through the ``flash_prefill`` kernel; the decode steps are plain
PyTorch, as JAX's ``decode_step`` is plain XLA.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core.fusion import model_fusion_report
from repro_torch.core.memory_tiers import (Symbol, allocate_static,
                                         plan_placement)
from repro_torch.models import get_model

PROMPT = (2, 16)
MAX_LEN = 32
DECODE_STEPS = 4


def forward_logits(model, params, toks):
    return model.forward(params, {"tokens": toks})


def prefill_and_decode(model, params, toks, n_steps=DECODE_STEPS):
    """Prefill ``toks`` (B, S) into a ``MAX_LEN`` cache, then ``n_steps``
    greedy decode steps; returns each step's tokens (B,) as numpy."""
    last, cache = model.prefill(params, {"tokens": toks}, max_len=MAX_LEN)
    tok = last.argmax(-1)
    out = []
    for t in range(n_steps):
        lg, cache = model.decode_step(params, cache, tok[:, None],
                                      toks.shape[1] + t)
        tok = lg.argmax(-1)
        out.append(tok.cpu().numpy())
    return out


def placement_symbols():
    """Step 4's symbols: overlapping lifetimes never share addresses;
    spilling picks the lowest-bandwidth symbols first."""
    return [
        Symbol("weights", 6 << 20, 0, 100, read_only=True,
               transfer_footprint=600 << 20),
        Symbol("kv_cache", 3 << 20, 0, 100, transfer_footprint=300 << 20),
        Symbol("act_a", 2 << 20, 1, 2, transfer_footprint=2 << 20),
        Symbol("act_b", 2 << 20, 3, 4, transfer_footprint=2 << 20),
    ]


def main(argv=None):
    """Returns what it printed, for a caller that checks it: the config,
    params, prompt, forward logits, decoded tokens, fusion report and
    placement."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a Llama2-7B-class expert (reduced so it runs on a laptop CPU)
    cfg = reduced(get_config("samba-coe-expert-7b"))
    model = get_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.2f}M")

    # 2. forward + prefill + a few decode steps
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, PROMPT), device=device)
    with torch.no_grad():
        logits = forward_logits(model, params, toks)
        print("forward logits:", tuple(logits.shape))
        steps = prefill_and_decode(model, params, toks)
    for t, tok in enumerate(steps):
        print("decode step", t, "->", tok)

    # 3. the paper's fusion ledger for this model (Fig 11 / Table I analogue)
    rep = model_fusion_report(get_config("samba-coe-expert-7b"), batch=8,
                              ctx=4096)
    print(f"fusion: {rep.unfused_kernels} unfused kernels -> "
          f"{rep.fused_kernels} fused ({rep.launch_ratio:.1f}x), "
          f"intensity {rep.intensity_unfused:.1f} -> "
          f"{rep.intensity_fused:.1f} flops/byte")

    # 4. static lifetime allocation (paper §V-A): the placement under a
    # 10 MiB HBM spills both activations, so their sharing is shown where
    # both are placed, by the allocator alone
    alloc, spilled = plan_placement(placement_symbols(),
                                    hbm_capacity=10 << 20)
    a, b = alloc.offsets.get("act_a"), alloc.offsets.get("act_b")
    print(f"placement: peak={alloc.peak >> 20}MiB spilled={spilled}"
          + ("" if a is None or b is None else
             f" (act_a/act_b share an address: {a == b})"))
    whole = allocate_static(placement_symbols())
    a, b = whole.offsets["act_a"], whole.offsets["act_b"]
    print(f"allocate_static: peak={whole.peak >> 20}MiB act_a@{a} "
          f"act_b@{b} (act_a/act_b share an address: {a == b})")
    return dict(cfg=cfg, params=params, tokens=toks, logits=logits,
                steps=steps, fusion=rep, alloc=alloc, spilled=spilled,
                static=whole)


if __name__ == "__main__":
    main()

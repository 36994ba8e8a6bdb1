"""PyTorch / CUDA port of the Samba-CoE serving system for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
and function names (``repro_torch.serving.engine.ServingEngine`` is the
counterpart of ``repro.serving.engine.ServingEngine``) and imports nothing of
it. Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means the card. A CUDA device with no
    card present raises; only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

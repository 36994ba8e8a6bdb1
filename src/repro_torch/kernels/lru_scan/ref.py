"""Plain PyTorch version of the RG-LRU recurrence kernel."""
from __future__ import annotations

import torch


def lru_scan_ref(a, b):
    """a, b (B, S, D) -> h (B, S, D) with h_t = a_t h_{t-1} + b_t, h_{-1} = 0.

    A Hillis-Steele doubling scan: ceil(log2 S) vectorised steps, step d
    composing each position with the one d before it, ``(a1, h1) then
    (a2, h2) = (a1 a2, a2 h1 + h2)``. It sums in another order than the
    kernel's sequential walk (and than JAX's associative_scan), so the two
    agree to f32 rounding, not bit for bit."""
    A, H = a, b
    S = a.shape[1]
    d = 1
    while d < S:
        H = torch.cat([H[:, :d], A[:, d:] * H[:, :-d] + H[:, d:]], dim=1)
        A = torch.cat([A[:, :d], A[:, d:] * A[:, :-d]], dim=1)
        d *= 2
    return H

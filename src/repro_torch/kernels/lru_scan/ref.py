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


def lru_scan_bwd_ref(a, h, dh):
    """(da, db) of ``h = lru_scan_ref(a, b)`` for the upstream gradient dh,
    all (B, S, D): g_t = dh_t + a_{t+1} g_{t+1} with g_S = 0 (the same
    recurrence run backwards, here as ``lru_scan_ref`` of the time-reversed
    inputs), db = g, da_t = g_t h_{t-1} with h_{-1} = 0."""
    zero = torch.zeros_like(a[:, :1])
    a_next = torch.cat([a[:, 1:], zero], dim=1)
    g = lru_scan_ref(a_next.flip(1), dh.flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g

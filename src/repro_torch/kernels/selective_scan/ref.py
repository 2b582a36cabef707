"""Plain PyTorch oracle for the selective scan, the reference's
``selective_scan_ref`` op for op: one step of the recurrence at a time, in
float32."""
from __future__ import annotations

import torch


def selective_scan_ref(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                       h0: torch.Tensor | None = None):
    """h_t = a_t ⊙ h_{t-1} + b_t ;  y_t = Σ_n C_t[n]·h_t[:, n]

    a, b: [B, T, D, N] (a ∈ (0, 1]); C: [B, T, N]; h0: [B, D, N].
    Returns (y [B, T, D], h_last [B, D, N]), float32.
    """
    B, T, D, N = a.shape
    f32 = torch.float32
    h = (torch.zeros((B, D, N), dtype=f32, device=a.device) if h0 is None
         else h0.to(f32))
    a, b, C = a.to(f32), b.to(f32), C.to(f32)
    ys = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, D), dtype=f32, device=a.device))
    return y, h

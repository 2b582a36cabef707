"""Plain PyTorch oracle for the RWKV-6 WKV recurrence, the reference's
``wkv6_ref`` op for op: one step of the recurrence at a time, in
float32."""
from __future__ import annotations

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor | None = None):
    """r, k, v, w: [B, T, H, n] (w in (0, 1)); u: [H, n]; s0: [B, H, n, n].

    y_t = r_t · (S_{t-1} + diag(u)·k_tᵀv_t);  S_t = diag(w_t)·S_{t-1} + k_tᵀv_t
    Returns (y [B, T, H, n], S_final [B, H, n, n]), all float32.
    """
    B, T, H, n = r.shape
    f32 = torch.float32
    s = (torch.zeros((B, H, n, n), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    r, k, v, w = (x.to(f32) for x in (r, k, v, w))
    uu = u.to(f32)[None, :, :, None]
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, n, n]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, n), dtype=f32, device=r.device))
    return y, s

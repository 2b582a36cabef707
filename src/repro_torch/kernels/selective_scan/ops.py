"""Public entry of the selective scan, with the reference's signature: a
CUDA tensor runs the hand-written kernel, a CPU tensor its plain PyTorch
version, and any other device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan.kernel import selective_scan_fwd


def selective_scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                   h0: torch.Tensor | None = None):
    """h_t = a_t⊙h_{t-1} + b_t; y_t = C_t·h_t.  a, b: [B, T, D, N]; C:
    [B, T, N]; h0: [B, D, N] (zeros when None).  Returns (y [B, T, D],
    h_last [B, D, N]), float32.

    As the reference's wrapper does, the inputs are cast to float32; they
    are also made contiguous.
    """
    B, T, D, N = a.shape
    if h0 is None:
        h0 = torch.zeros((B, D, N), dtype=torch.float32, device=a.device)
    f32 = torch.float32
    return selective_scan_fwd(a.to(f32).contiguous(),
                              b.to(f32).contiguous(),
                              C.to(f32).contiguous(),
                              h0.to(f32).contiguous())

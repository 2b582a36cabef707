"""Public entry of the selective scan, with the reference's signature: a
CUDA tensor runs the hand-written kernels, a CPU tensor their plain
PyTorch versions, and any other device raises.

It is differentiable.  Where autograd records (grad enabled and an input
that requires grad) the call goes through :class:`SelectiveScan`, a
``torch.autograd.Function`` whose forward runs the forward kernel with
its checkpoints and saves ``a, b, C, h0`` and them, and whose backward
runs the backward kernel.  Otherwise (the serving path) it is one forward
launch with no checkpoints, so serving writes nothing more.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan.kernel import (selective_scan_bwd,
                                                       selective_scan_fwd)


class SelectiveScan(torch.autograd.Function):
    """(a, b, C, h0) -> (y, h_last), with the backward kernel as its
    gradient.  The inputs are float32 and contiguous."""

    @staticmethod
    def forward(ctx, a, b, C, h0):
        y, h_last, hck = selective_scan_fwd(a, b, C, h0, checkpoints=True)
        ctx.save_for_backward(a, b, C, h0, hck)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, b, C, h0, hck = ctx.saved_tensors
        return selective_scan_bwd(a, b, C, h0, dy.contiguous(),
                                  dh_last.contiguous(), checkpoints=hck)


def selective_scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                   h0: torch.Tensor | None = None):
    """h_t = a_t⊙h_{t-1} + b_t; y_t = C_t·h_t.  a, b: [B, T, D, N]; C:
    [B, T, N]; h0: [B, D, N] (zeros when None).  Returns (y [B, T, D],
    h_last [B, D, N]), float32.

    As the reference's wrapper does, the inputs are cast to float32; they
    are also made contiguous, outside :class:`SelectiveScan`, so that
    autograd carries the casts.
    """
    B, T, D, N = a.shape
    if h0 is None:
        h0 = torch.zeros((B, D, N), dtype=torch.float32, device=a.device)
    f32 = torch.float32
    a, b, C, h0 = (x.to(f32).contiguous() for x in (a, b, C, h0))
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (a, b, C, h0)):
        return SelectiveScan.apply(a, b, C, h0)
    return selective_scan_fwd(a, b, C, h0)

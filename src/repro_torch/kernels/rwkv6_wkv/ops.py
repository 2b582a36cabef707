"""Public entry of the WKV-6 recurrence, with the reference's signature: a
CUDA tensor runs the hand-written kernels, a CPU tensor their plain
PyTorch versions, and any other device raises.

It is differentiable.  Where autograd records (grad enabled and an input
that requires grad) the call goes through :class:`WKV6`, a
``torch.autograd.Function`` whose forward runs the forward kernel with its
checkpoints and saves the inputs and them, and whose backward runs the
backward kernel.  Otherwise (the serving path) it is one forward launch
with no checkpoints, so serving writes nothing more.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_bwd, wkv6_fwd


class WKV6(torch.autograd.Function):
    """(r, k, v, w, u, s0) -> (y, S_final), with the backward kernel as its
    gradient.  The inputs are float32 and contiguous."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, s_final, ck = wkv6_fwd(r, k, v, w, u, s0, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, s0, ck)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, dS_T):
        r, k, v, w, u, s0, ck = ctx.saved_tensors
        return wkv6_bwd(r, k, v, w, u, s0, dy.contiguous(),
                        dS_T.contiguous(), checkpoints=ck)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor | None = None, *,
         chunk: int = 32):
    """r, k, v, w: [B, T, H, n]; u: [H, n]; s0: [B, H, n, n] (zeros when
    None).  Returns (y [B, T, H, n], S_final [B, H, n, n]), float32.

    As the reference's wrapper does, the inputs are cast to float32; they
    are also made contiguous, outside :class:`WKV6`, so that autograd
    carries the casts.  The kernels read the [B, T, H, n] layout as it is,
    with no [B·H, T, n] copies.  ``chunk`` is the reference's tile length:
    it is accepted and does not change the result, since the kernels walk
    T one step at a time.
    """
    B, T, H, n = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
    f32 = torch.float32
    xs = [x.to(f32).contiguous() for x in (r, k, v, w, u, s0)]
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return WKV6.apply(*xs)
    return wkv6_fwd(*xs)

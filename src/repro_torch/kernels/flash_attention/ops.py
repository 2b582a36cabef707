"""Public entry of causal GQA flash attention, in the reference's
[B, S, heads, hd] layout: a CUDA tensor runs the hand-written kernels, a
CPU tensor their plain PyTorch versions, and any other device raises.

It is differentiable.  Where autograd records (grad enabled and an input
that requires grad) the call goes through :class:`FlashAttention`, a
``torch.autograd.Function`` whose forward runs the forward kernel with
its ``lse`` output and saves ``q, k, v, out, lse``, and whose backward runs
the backward kernel.  Otherwise (the serving path) it is one forward
launch with no ``lse``, so serving writes nothing more.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)


class FlashAttention(torch.autograd.Function):
    """(q, k, v, window) -> out, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention_fwd(q, k, v, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         window=ctx.window)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, KV, hd]; causal (+ optional window).

    The kernel reads the model's layout directly, so unlike the
    reference's wrapper this one transposes nothing; it makes the inputs
    contiguous, which the projections' reshapes already are.
    """
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, int(window))
    return flash_attention_fwd(q, k, v, window=int(window))

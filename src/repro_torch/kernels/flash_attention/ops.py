"""Public entry of causal GQA flash attention, in the reference's
[B, S, heads, hd] layout: a CUDA tensor runs the hand-written kernel, a
CPU tensor its plain PyTorch version, and any other device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, KV, hd]; causal (+ optional window).

    The kernel reads the model's layout directly, so unlike the
    reference's wrapper this one transposes nothing; it makes the inputs
    contiguous, which the projections' reshapes already are.
    """
    return flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), window=int(window))

"""Public entry of the WKV-6 recurrence, with the reference's signature: a
CUDA tensor runs the hand-written kernel, a CPU tensor its plain PyTorch
version, and any other device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_fwd


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor | None = None, *,
         chunk: int = 32):
    """r, k, v, w: [B, T, H, n]; u: [H, n]; s0: [B, H, n, n] (zeros when
    None).  Returns (y [B, T, H, n], S_final [B, H, n, n]), float32.

    As the reference's wrapper does, the inputs are cast to float32; they
    are also made contiguous.  The kernel reads the [B, T, H, n] layout as
    it is, with no [B·H, T, n] copies.  ``chunk`` is the reference's tile
    length: it is accepted and does not change the result, since the
    kernel walks T one step at a time with no chunks.
    """
    B, T, H, n = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
    f32 = torch.float32
    return wkv6_fwd(*(x.to(f32).contiguous() for x in (r, k, v, w, u, s0)))

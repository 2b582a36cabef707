"""Plain PyTorch oracles for the support-count and intersect kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.support_count.fused import popcount32

# float32 holds every integer below 2**24 exactly, so a float32 product of
# 0/1 matrices is an exact count up to this many items.  0 and 1 are exact
# in TF32 and bf16 as well, and the card accumulates in float32 either
# way, so the result does not depend on the float32 matmul precision.
MAX_EXACT_ITEMS = 1 << 24


def support_count_ref(T: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """T: [N, I] 0/1 transactions; C: [M, I] 0/1 candidate masks.

    support[m] = #{ t : T[t] ∧ C[m] == C[m] }  (itemset containment count),
    as ``[M]`` int32.  The dot runs in float32 because CUDA matmul takes no
    integer operands.
    """
    if T.shape[1] >= MAX_EXACT_ITEMS:
        raise ValueError(f"{T.shape[1]} items: float32 counts are exact "
                         f"only below {MAX_EXACT_ITEMS}")
    Cf = C.to(torch.float32)
    dots = T.to(torch.float32) @ Cf.T                                # [N, M]
    sizes = Cf.sum(dim=1)                                            # [M]
    return (dots == sizes[None, :]).sum(dim=0, dtype=torch.int32)    # [M]


def intersect_count_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A, B: [M, W] int32 words holding uint32 tid-list bit patterns (bit b
    of word w = transaction 32w+b).

    counts[m] = |tidset(A[m]) ∩ tidset(B[m])| = Σ_w popcount(A[m,w] & B[m,w]),
    as ``[M]`` int32.  ``popcount32`` takes values in [0, 2**32) and a word
    with bit 31 set is a negative int32, so the AND is widened to int64 and
    masked to its 32 bits first.
    """
    inter = (A & B).to(torch.int64) & 0xFFFFFFFF                     # [M, W]
    return popcount32(inter).sum(dim=1, dtype=torch.int32)           # [M]

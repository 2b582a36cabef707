"""Public wrapper for the support-count kernel family: padding and variant
dispatch.

Two kernels compute the same counts bit-identically:

* ``packed`` — the packed-popcount kernel (:mod:`.fused`): items packed
  32 to a word, containment + filter + count in one launch.  The default,
  as the reference's checked-in autotune cache picks it on every bucket.
* ``mxu``    — the int8 tensor-core kernel (:mod:`.kernel`).

On a CUDA tensor each runs its hand-written kernel; on a CPU tensor its
plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.support_count.fused import (pack_words,
                                                     support_count_packed)
from repro_torch.kernels.support_count.kernel import support_count_int8

VARIANTS = ("packed", "mxu")


def resolve_variant(tuning: Optional[dict]) -> str:
    """``None`` = ``packed``; a dict ``{"variant": ...}`` pins the choice."""
    if tuning is None:
        return "packed"
    if not isinstance(tuning, dict) or tuning.get("variant") not in VARIANTS:
        raise ValueError(f"tuning must be None or a dict naming a variant "
                         f"in {VARIANTS}, got {tuning!r}")
    return tuning["variant"]


def _pad_to(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad      # F.pad counts from last
    return torch.nn.functional.pad(x, widths)


def _as_int8(x: torch.Tensor) -> torch.Tensor:
    # a 0/1 uint8 bitmap has the same bytes as int8: view, don't copy
    return x.view(torch.int8) if x.dtype == torch.uint8 else x.to(torch.int8)


def support_count(T: torch.Tensor, C: torch.Tensor, *,
                  tuning: Optional[dict] = None) -> torch.Tensor:
    """Support counts [M] int32 of candidate masks C [M, I] over
    transactions T [N, I] (0/1, same device).

    Pads N→8·, M→128·, I→128· with zero rows/items; padded candidate rows
    have |c| = 0 and would match every transaction, so the counts are
    sliced back to M rather than trusted.  Padded transaction rows are
    all-zero and match only |c| = 0 sets, which real candidates never are.
    """
    variant = resolve_variant(tuning)
    M0 = C.shape[0]
    if M0 == 0:          # empty candidate level: nothing to count
        return torch.zeros(0, dtype=torch.int32, device=T.device)
    T = _pad_to(_pad_to(_as_int8(T), 1, 128), 0, 8).contiguous()
    C = _pad_to(_pad_to(_as_int8(C), 1, 128), 0, 128).contiguous()
    sizes = C.sum(dim=1, dtype=torch.int32)
    if variant == "packed":
        out = support_count_packed(pack_words(T), pack_words(C), sizes)
    else:
        out = support_count_int8(T, C, sizes)
    return out[:M0]

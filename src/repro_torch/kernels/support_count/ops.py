"""Public wrappers for the support-count kernel family: padding and variant
dispatch, and the Eclat plane's ``intersect_count``.

Two kernels compute the same counts bit-identically:

* ``packed`` — the packed-popcount kernel (:mod:`.fused`): items packed
  32 to a word, containment + filter + count in one launch.
* ``mxu``    — the int8 tensor-core kernel (:mod:`.kernel`).

Which one runs comes from the autotune cache
(:mod:`repro_torch.kernels.autotune`) keyed by (kernel, shape bucket,
device kind), swept on the card; with no entry for the device the
roofline-seeded default applies, which is ``packed`` at every shape.  On
a CUDA tensor each runs its hand-written kernel; on a CPU tensor its
plain PyTorch version.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels.autotune.cache import AutotuneCache, resolve_config
from repro_torch.kernels.support_count.fused import (pack_words,
                                                     support_count_packed)
from repro_torch.kernels.support_count.intersect import intersect_count_words
from repro_torch.kernels.support_count.kernel import support_count_int8
from repro_torch.launch.tuning import VARIANTS


def check_tuning(tuning: Any, kernel: str = "support_count") -> None:
    """Reject a malformed ``tuning`` before any launch: it must be
    ``None`` (the default cache), ``False`` (the roofline-seeded default),
    an :class:`AutotuneCache`, or a dict pinning a variant of ``kernel``."""
    if tuning is None or tuning is False or isinstance(tuning,
                                                       AutotuneCache):
        return
    if not isinstance(tuning, dict) or \
            tuning.get("variant") not in VARIANTS[kernel]:
        raise ValueError(f"tuning must be None, False, an AutotuneCache or "
                         f"a dict naming a variant in {VARIANTS[kernel]}, "
                         f"got {tuning!r}")


def resolve_variant(kernel: str, shape: Tuple[int, ...], tuning: Any,
                    device: torch.device) -> str:
    """The variant ``kernel`` runs at the padded ``shape`` on ``device``:
    ``tuning`` (already through :func:`check_tuning`) resolved by
    :func:`repro_torch.kernels.autotune.cache.resolve_config`."""
    cfg = resolve_config(kernel, shape, tuning, device)
    if cfg.get("variant") not in VARIANTS[kernel]:
        raise ValueError(f"{kernel} config {cfg!r} for {shape} names no "
                         f"variant in {VARIANTS[kernel]}")
    return cfg["variant"]


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
                  tuning: Any = None) -> torch.Tensor:
    """Support counts [M] int32 of candidate masks C [M, I] over
    transactions T [N, I] (0/1, same device).

    Pads N→8·, M→128·, I→128· with zero rows/items; padded candidate rows
    have |c| = 0 and would match every transaction, so the counts are
    sliced back to M rather than trusted.  Padded transaction rows are
    all-zero and match only |c| = 0 sets, which real candidates never are.

    ``tuning``: ``None`` = the checked-in autotune cache; ``False`` = the
    roofline-seeded default; a dict ``{"variant": ...}`` or an
    ``AutotuneCache`` pins the choice.
    """
    check_tuning(tuning)
    M0 = C.shape[0]
    if M0 == 0:          # empty candidate level: nothing to count
        return torch.zeros(0, dtype=torch.int32, device=T.device)
    T = _pad_to(_pad_to(_as_int8(T), 1, 128), 0, 8).contiguous()
    C = _pad_to(_pad_to(_as_int8(C), 1, 128), 0, 128).contiguous()
    variant = resolve_variant("support_count",
                              (T.shape[0], C.shape[0], T.shape[1]), tuning,
                              T.device)
    sizes = C.sum(dim=1, dtype=torch.int32)
    if variant == "packed":
        out = support_count_packed(pack_words(T), pack_words(C), sizes)
    else:
        out = support_count_int8(T, C, sizes)
    return out[:M0]


def intersect_count(A: torch.Tensor, B: torch.Tensor, *,
                    tuning: Any = None) -> torch.Tensor:
    """Row-aligned tid-slab intersection counts [M] int32 (Eclat primitive).

    A, B: [M, W] packed tid-list words (int32 bit patterns, same device):
    row m of the output is |tidset(A[m]) ∩ tidset(B[m])|.  Pads M→128·,
    W→128· with zero words (inert: popcount(0) == 0) and slices padded
    rows away.

    ``tuning`` follows the family contract (see :func:`support_count`);
    the kernel has one variant, ``packed``, so a valid ``tuning`` leaves
    nothing to resolve.
    """
    check_tuning(tuning, "intersect_count")
    if A.shape != B.shape:
        raise ValueError(f"slab shapes differ: {tuple(A.shape)} vs "
                         f"{tuple(B.shape)}")
    M0 = A.shape[0]
    if M0 == 0:          # empty candidate level: nothing to intersect
        return torch.zeros(0, dtype=torch.int32, device=A.device)
    A = _pad_to(_pad_to(A, 1, 128), 0, 128).contiguous()
    B = _pad_to(_pad_to(B, 1, 128), 0, 128).contiguous()
    return intersect_count_words(A, B)[:M0]

"""Public wrapper for the rule-match kernel family: batched top-k
recommendation (padding, backend and variant dispatch — the same idiom as
``repro_torch.kernels.support_count.ops``).

Two kernels compute bit-identical [B, R] score matrices:

* ``packed`` — the packed-popcount kernel (:mod:`.fused`): subset test +
  confidence weighting in one launch over 32-item words.
* ``mxu``    — the int8 tensor-core kernel (:mod:`.kernel`).

Which one runs comes from the autotune cache, as for support counting
(``packed`` on a device without entries).

On a CUDA tensor each runs its hand-written kernel; on a CPU tensor its
plain PyTorch version.  Either way the scores fold through the shared
``topk_from_scores``, so the backends cannot drift on serving semantics.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels.rule_match.fused import rule_scores_fused
from repro_torch.kernels.rule_match.kernel import rule_scores_int8
from repro_torch.kernels.rule_match.ref import (rule_scores_ref,
                                                topk_from_scores)
from repro_torch.kernels.support_count.ops import (_as_int8, _pad_to,
                                                   check_tuning,
                                                   resolve_variant)

BACKENDS = ("cuda", "ref")


def _pad_rows(x: torch.Tensor, n: int, value: float = 0) -> torch.Tensor:
    """Pad axis 0 of ``x`` up to ``n`` rows filled with ``value``."""
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad),
                                   value=value)


def rule_topk(Q: torch.Tensor, A: torch.Tensor, sizes: torch.Tensor,
              conf: torch.Tensor, cons: torch.Tensor, *, k: int,
              n_items: int, backend: Optional[str] = None,
              tuning: Any = None):
    """Top-k item recommendations for a batch of query baskets.

    Q: [B, I] 0/1 baskets; A: [R, I] 0/1 antecedent masks; sizes: [R]
    (=|A_r|); conf: [R] rule confidences; cons: [R] consequent item ids —
    all tensors on one device.  Pads B→8·, R→128·, I→128· as the kernels
    require — padded rule rows get ``sizes=-1`` (never match; an all-zero
    row would match everything), ``conf=0`` and ``cons=I_padded`` (a dummy
    max-segment sliced away).  An empty index (R=0) still pads to 128 rows
    that every query simply fails to match.  Returns (items [B, k] int32,
    scores [B, k] float32) ordered by (score desc, item id asc); entries
    with score <= 0 are non-matches the caller should drop.

    ``backend``: ``"cuda"`` scores through the kernel wrappers, ``"ref"``
    through the plain oracle; ``None`` = ``cuda`` on a CUDA tensor, else
    ``ref``.  ``tuning``: ``None`` = the checked-in autotune cache;
    ``False`` = the roofline-seeded default (``packed``); a dict
    ``{"variant": ...}`` or an ``AutotuneCache`` pins the choice.
    """
    if backend is None:
        backend = "cuda" if Q.device.type == "cuda" else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    check_tuning(tuning, "rule_match")
    B0, I0 = Q.shape
    R0 = A.shape[0]
    if not 0 < k <= I0:
        raise ValueError(f"k={k} must be in [1, n_query_items={I0}]")
    if n_items > I0 or A.shape[1] != I0:
        raise ValueError(f"item-axis mismatch: Q {tuple(Q.shape)}, "
                         f"A {tuple(A.shape)}, n_items={n_items}")
    Ip = I0 + (-I0) % 128
    Q = _pad_to(_pad_to(_as_int8(Q), 1, 128), 0, 8).contiguous()
    # an empty rule set still pads to one full lane block of never-match
    # rows so the kernel grid stays non-degenerate
    Rp = max(R0 + (-R0) % 128, 128)
    A = _pad_rows(_pad_to(_as_int8(A), 1, 128), Rp).contiguous()
    sizes = _pad_rows(sizes.to(torch.float32), Rp, -1.0)
    conf = _pad_rows(conf.to(torch.float32), Rp)
    cons = _pad_rows(cons.to(torch.int32), Rp, Ip)
    if backend == "ref":
        scores = rule_scores_ref(Q, A, sizes, conf)
    elif resolve_variant("rule_match", (Q.shape[0], Rp, Ip), tuning,
                         Q.device) == "packed":
        scores = rule_scores_fused(Q, A, sizes, conf)
    else:
        scores = rule_scores_int8(Q, A, sizes, conf)
    items, top = topk_from_scores(scores, Q, cons, n_items, k)
    return items[:B0], top[:B0]


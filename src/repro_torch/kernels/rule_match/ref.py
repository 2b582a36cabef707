"""Plain PyTorch oracle for the rule-match kernel family.

Serving semantics (shared by this oracle, the CUDA kernels + ops wrapper,
the serving engine, and the brute-force test oracle in
``repro_torch.serving.oracle``):

  score[q, r] = confidence[r]  if antecedent_r ⊆ basket_q  else 0
  item[q, j]  = max over rows r with consequent[r] == j of score[q, r]
                (0 when no matching rule names j)
  items already in basket_q — and lane-padding item ids — score -1,
  so they can never enter the top-k
  top-k per query ordered by (score desc, item id asc)

Index padding contract: padded rule rows carry ``sizes = -1`` (an all-zero
antecedent row would otherwise subset-match every basket), ``conf = 0`` and
``cons = n_items_padded`` (a dummy segment sliced away before the top-k).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.support_count.ref import MAX_EXACT_ITEMS


def rule_scores_ref(Q: torch.Tensor, A: torch.Tensor, sizes: torch.Tensor,
                    conf: torch.Tensor) -> torch.Tensor:
    """Q: [B, I] 0/1 baskets; A: [R, I] 0/1 antecedent masks; sizes: [R]
    (=|A_r|, -1 on padded rows); conf: [R] -> [B, R] float32 scores.  The
    dot runs in float32 (CUDA matmul takes no integer operands), exact
    because every dot is an integer below 2**24."""
    if Q.shape[1] >= MAX_EXACT_ITEMS:
        raise ValueError(f"{Q.shape[1]} items: float32 dots are exact only "
                         f"below {MAX_EXACT_ITEMS}")
    dots = Q.to(torch.float32) @ A.to(torch.float32).T               # [B, R]
    match = dots == sizes.to(torch.float32)[None, :]
    return match.to(torch.float32) * conf.to(torch.float32)[None, :]


def topk_from_scores(scores: torch.Tensor, Q: torch.Tensor,
                     cons: torch.Tensor, n_items: int, k: int):
    """Rule scores [B, R] -> per-item max-confidence -> top-k.

    The single definition of the post-matching semantics: the plain
    oracle and the kernel path fold their score matrices through this.
    The segment max scatters into zeros, which is the reference's
    ``max(segment_max, 0)``; the top-k is a stable descending sort, so
    equal scores keep the lower item id first (``torch.topk`` promises
    no order among ties).
    """
    B, R = scores.shape
    Ip = Q.shape[1]
    seg = torch.zeros((B, Ip + 1), dtype=torch.float32, device=scores.device)
    seg.scatter_reduce_(1, cons.to(torch.int64)[None, :].expand(B, R),
                        scores, reduce="amax")
    item_scores = seg[:, :Ip]
    valid = (torch.arange(Ip, device=Q.device)[None, :] < n_items) & (Q == 0)
    masked = torch.where(valid, item_scores, -1.0)
    top_scores, top_items = torch.sort(masked, dim=1, descending=True,
                                       stable=True)
    return top_items[:, :k].to(torch.int32), top_scores[:, :k]


def recommend_ref(Q: torch.Tensor, A: torch.Tensor, sizes: torch.Tensor,
                  conf: torch.Tensor, cons: torch.Tensor, n_items: int,
                  k: int):
    """Full oracle: rule scores -> per-item max-confidence -> top-k.

    cons: [R] consequent item id per rule row (n_items_padded on padded
    rows).  Returns (items [B, k] int32, scores [B, k] float32).
    """
    scores = rule_scores_ref(Q, A, sizes, conf)                      # [B, R]
    return topk_from_scores(scores, Q, cons, n_items, k)

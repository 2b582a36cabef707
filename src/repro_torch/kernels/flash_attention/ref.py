"""Plain PyTorch oracle for causal (optionally sliding-window) GQA
attention, the reference's ``flash_attention_ref`` op for op."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, KV, hd]; causal; window <= 0 means
    full.  Query head h reads kv head ``h // (H/KV)``; the softmax runs in
    float32 and is cast to the input dtype before the product with v."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    s = s / math.sqrt(hd)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = kj <= qi
    if window > 0:
        mask &= kj > qi - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)

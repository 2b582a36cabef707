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


def _scores_f32(q, k, window):
    """Scaled float32 scores [B, H, S, S] from upcast q and k, and the
    live-key mask [S, S] (the kernels' arithmetic: exact products, float32
    sums)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf)
    s = s * (1.0 / math.sqrt(hd))
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = kj <= qi
    if window > 0:
        mask &= kj > qi - window
    return s, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            window: int = 0) -> torch.Tensor:
    """The softmax's log-normaliser ``lse`` [B, H, S] (float32) that the
    forward kernel writes beside its output: ``log sum_j exp(s_ij)`` over
    the live keys of the scaled scores."""
    s, mask = _scores_f32(q, k, window)
    return torch.logsumexp(torch.where(mask[None, None], s, NEG_INF), dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            window: int = 0):
    """(dq, dk, dv) of the causal GQA attention above, written out as
    tensor ops from P recomputed from ``lse``, with no autograd: an oracle
    independent of the forward's graph.  Every product is float32 on
    upcast inputs; P enters dV rounded to the input type, as it enters
    P.V in the forward.  A kv head's dk and dv sum over its H/KV query
    heads.

        P  = exp(s - lse)            (0 where the key is masked)
        D  = rowsum(dO ∘ O)
        dV = P^T dO,  dP = dO V^T,  dS = P ∘ (dP - D)
        dQ = scale · dS K,  dK = scale · dS^T Q
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    s, mask = _scores_f32(q, k, window)
    p = torch.where(mask[None, None], torch.exp(s - lse[..., None]), 0.0)
    do = dout.to(f32)
    d = (do * out.to(f32)).sum(-1).transpose(1, 2)          # [B, H, S]
    vf = v.to(f32).repeat_interleave(H // KV, dim=2)
    kf = k.to(f32).repeat_interleave(H // KV, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f32)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(f32), do)
    # a kv head's gradient is the sum over its group of query heads
    dk = dk.reshape(B, S, KV, H // KV, hd).sum(3)
    dv = dv.reshape(B, S, KV, H // KV, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_block_err(got: torch.Tensor, want: torch.Tensor, rtol: float,
                  atol: float, rows: int = 64, row_bound=None) -> float:
    """The gate that holds a backward kernel's dq, dk or dv against this
    oracle's: the largest ||got - want|| / (rtol·||want|| + atol·√n) over
    the blocks of ``rows`` sequence rows (n elements) of each batch row
    and head of two [B, S, heads, hd] tensors, at most 1 where every block
    is within its limit.  A tile-sized block holds the late rows, whose
    gradients are small, as tightly as the early ones.  ``row_bound``
    ([B, S, heads], e.g. :func:`bwd_cancel_bound`'s) replaces the atol
    term by the block's rows' bounds in quadrature."""
    B, S, Hh, hd = want.shape
    n = -(-S // rows)
    x = want.float().new_zeros((3, B, n * rows, Hh, hd))
    x[0, :, :S] = got.float() - want.float()
    x[1, :, :S] = want.float()
    if row_bound is not None:
        x[2, :, :S, :, 0] = row_bound
    d, w, r = x.reshape(3, B, n, rows, Hh, hd).square().sum((3, 5)).sqrt()
    if row_bound is None:
        r = atol * (rows * hd) ** 0.5
    return float((d / (rtol * w + r)).max())


def bwd_cancel_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor):
    """At window 1 (P = 1), the float32 rounding that two evaluations of
    each row's dS = dP - D may differ by: each side sums the same hd terms
    dO_d·V_d twice (dP and D), which cancel, and each sum rounds by about
    u·Σ_d |dO_d·V_d| (u = ε/2), so four such errors bound the difference,
    2ε·Σ_d |dO_d·V_d|.  It is carried into dQ by |K_i|·scale and into dK
    by |Q_i|·scale summed over the key's query heads.  Returns the per-row
    bounds ([B, S, H] for dQ, [B, S, KV] for dK)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    eps = torch.finfo(torch.float32).eps
    scale = hd ** -0.5
    c = 2 * (dout.float() * v.float().repeat_interleave(G, dim=2)
             ).abs().sum(-1)
    dq = eps * c * k.float().repeat_interleave(G, dim=2).norm(dim=-1) * scale
    dk = (eps * c * q.float().norm(dim=-1) * scale).view(B, S, -1, G).sum(-1)
    return dq, dk

"""Shared neural-net building blocks, as plain functions on tensors.

Parameters are nested dicts of tensors, in the reference's tree layout.
Initializers take an explicit ``torch.Generator`` and device and return
such dicts; apply functions are pure.  The numeric conventions are the
reference's: parameters in ``cfg.param_dtype``, normalisation and RoPE
computed in float32 and cast back.  The losses take float32 math over
logits of any type.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def sequence_shard(x: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel sharding hint (Korthikanti et al.): between
    blocks, activations [B, S, ...] are sharded on ("pod","data") × batch
    and "model" × sequence.  Under a mesh context a DTensor on the ambient
    mesh is redistributed to that spec; outside one, on a plain tensor,
    for rank < 3, a mesh without "model" or batch axes, or dims that do not
    divide, ``x`` comes back as it is."""
    from repro_torch.core.compat import axis_sizes, get_abstract_mesh
    from repro_torch.distributed.meshes import P, batch_axes, constrain

    mesh = get_abstract_mesh()
    if mesh is None or x.dim() < 3:
        return x
    sizes = axis_sizes(mesh)
    batch_ax = batch_axes(mesh)
    if "model" not in sizes or not batch_ax:
        return x
    bsz = math.prod(sizes[a] for a in batch_ax)
    if x.shape[0] % bsz != 0 or x.shape[1] % sizes["model"] != 0:
        return x
    return constrain(x, P(batch_ax, "model", *([None] * (x.dim() - 2))))


def sequence_gather(x: torch.Tensor) -> torch.Tensor:
    """The other half of sequence parallelism: a DTensor [B, S, ...] whose
    sequence dim is sharded is all-gathered over it before a block's
    projections, as Megatron's sequence parallelism does, so that no
    matmul folds a sharded sequence into its rows; anything else (a plain
    tensor, no ambient mesh) comes back as it is."""
    from repro_torch.core.compat import get_abstract_mesh
    from repro_torch.distributed.meshes import replicate_dim

    if get_abstract_mesh() is None or x.dim() < 3:
        return x
    return replicate_dim(x, 1)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """[in_dim, out_dim] normal weights scaled by ``1/√in_dim``, drawn in
    float32 on the generator's device and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype: torch.dtype,
                 device: torch.device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].to(torch.float32)).to(orig)


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split form: the first and second halves of the
# head dimension rotate as pairs)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to
    [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., seq, hd/2]
    angles = angles[..., None, :]                           # [..., seq, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> Params:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype),
        "w_up": dense_init(generator, d_model, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d_model, dtype),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits [..., V] in any float dtype (float32
    math)."""
    from repro_torch.distributed.meshes import replicate_dim

    # a vocab-sharded DTensor is gathered whole first: the label gather has
    # no DTensor strategy along a sharded dim (plain tensors pass as they
    # are)
    logits = replicate_dim(logits.to(torch.float32), -1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _vocab_chunk(x: torch.Tensor, wc: torch.Tensor, labels: torch.Tensor,
                 lo: int, m: torch.Tensor, s: torch.Tensor,
                 ll: torch.Tensor):
    """One vocab chunk of :func:`chunked_softmax_xent`: the running max,
    sum and label logit after the chunk's [T, chunk] logits."""
    from repro_torch.distributed.meshes import replicate_dim

    chunk = wc.shape[0]
    logits = replicate_dim((x @ wc.T).to(torch.float32), -1)  # [T, chunk]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits - m_new[:, None]).sum(-1)
    local = labels - lo
    in_chunk = (local >= 0) & (local < chunk)
    picked = torch.gather(logits, 1,
                          torch.clamp(local, 0, chunk - 1)[:, None])[:, 0]
    return m_new, s, torch.where(in_chunk, picked, ll)


def chunked_softmax_xent(x: torch.Tensor, embed: torch.Tensor,
                         labels: torch.Tensor, chunk: int,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Cross-entropy without materialising [tokens, V] logits.

    Walks the vocab in chunks with a running logsumexp, picking the label
    logit on the way.  x: [T, d] final hidden states, embed: [V, d] (the
    unembedding), labels: [T].  Each chunk runs under
    ``torch.utils.checkpoint``, as the reference's scan body runs under
    ``jax.checkpoint``: backward recomputes the chunk's [T, chunk] logits,
    so no [T, V] set of tiles is kept for it.
    """
    T_, d = x.shape
    V = embed.shape[0]
    if V % chunk:
        raise ValueError(f"vocab {V} is not a multiple of the chunk {chunk}")
    labels = labels.long()
    m = torch.full((T_,), -math.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((T_,), dtype=torch.float32, device=x.device)
    ll = torch.zeros((T_,), dtype=torch.float32, device=x.device)
    for i in range(V // chunk):
        m, s, ll = checkpoint(_vocab_chunk, x,
                              embed[i * chunk:(i + 1) * chunk], labels,
                              i * chunk, m, s, ll, use_reentrant=False)
    nll = (m + torch.log(s)) - ll
    if mask is not None:
        maskf = mask.to(torch.float32)
        return torch.sum(nll * maskf) / torch.clamp(torch.sum(maskf),
                                                    min=1.0)
    return torch.mean(nll)

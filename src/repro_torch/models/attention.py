"""Attention: GQA with sliding-window local and global layers, and MLA
(DeepSeek-V2's multi-head latent attention).

Two plain full-sequence implementations, as in the reference:

* ``naive``   — materialises the [B, H, S, S] score tensor;
* ``chunked`` — online softmax over KV chunks, O(S·chunk) memory.

They are the CPU path, which autograd differentiates.  On the card
``attention_full`` runs the hand-written flash kernel
(``repro_torch.kernels.flash_attention``) for either ``attention_impl``:
all three compute one function.  Its entry is differentiable, with the
hand-written backward kernel as its gradient, so a GQA layer trains on the
card.  Decoding one token
against the cache stays plain tensor code, as in the reference.  MLA is
plain tensor code on either device, by the reference's design: its q/k
head size (nope + rope, 192 at full width) differs from its v head size
(128), and the reference computes it outside its Pallas kernel.

Window semantics: ``window <= 0`` means full causal; ``window = w`` allows
key j for query i iff ``i - w < j <= i``.  Windows are Python ints, one per
layer (:func:`layer_windows`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from repro_torch.distributed.meshes import merge_last, split_last, write_at
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import Params, apply_rope, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA projections
# ---------------------------------------------------------------------------

def gqa_init(generator: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(generator, d, H * hd, dtype),
        "wk": dense_init(generator, d, KV * hd, dtype),
        "wv": dense_init(generator, d, KV * hd, dtype),
        "wo": dense_init(generator, H * hd, d, dtype),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return split_last(x, n)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Query head h reads kv head ``h // n_rep``."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _window_mask(qi: torch.Tensor, kj: torch.Tensor, window: int,
                 causal: bool = True) -> torch.Tensor:
    mask = torch.ones(torch.broadcast_shapes(qi.shape, kj.shape),
                      dtype=torch.bool, device=kj.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    return mask


# ---------------------------------------------------------------------------
# Core attention math (the plain versions)
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, *, causal: bool, window: int,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd].  Returns [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = _window_mask(qi, kj, window, causal)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def chunked_attention(q, k, v, *, causal: bool, window: int,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention, O(S·chunk) memory.  Shapes as naive."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    hd_v = v.shape[-1]
    if S % chunk != 0:
        return naive_attention(q, k, v, causal=causal, window=window)
    n_rep = H // KV
    scale = 1.0 / math.sqrt(hd)
    qi = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, hd_v), dtype=torch.float32, device=q.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_i = _repeat_kv(k[:, sl], n_rep)
        v_i = _repeat_kv(v[:, sl], n_rep)
        kj = i * chunk + torch.arange(chunk, device=q.device)[None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_i).to(torch.float32) * scale
        s = torch.where(_window_mask(qi, kj, window, causal)[None, None], s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), v_i).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)              # [B,S,H,hd]


def attention_full(q, k, v, cfg, window: int) -> torch.Tensor:
    """Causal attention over the whole sequence: the flash kernels (forward,
    and backward where autograd records) on the card, the configured plain
    form on the CPU."""
    if q.device.type != "cpu":
        return flash_attention(q, k, v, window=window)
    if cfg.attention_impl == "chunked":
        return chunked_attention(q, k, v, causal=True, window=window,
                                 chunk=cfg.attention_chunk)
    return naive_attention(q, k, v, causal=True, window=window)


# ---------------------------------------------------------------------------
# GQA block: full-sequence and decode
# ---------------------------------------------------------------------------

def _qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], H, hd)
    k = _split_heads(x @ p["wk"], KV, hd)
    v = _split_heads(x @ p["wv"], KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_forward(p: Params, cfg, x: torch.Tensor, window: int,
                positions=None) -> torch.Tensor:
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    if cfg.sequence_parallel:
        # keep q's SEQUENCE dim sharded on "model" through the attention
        # (kv replicated): head sharding degenerates to replication where
        # n_heads does not divide the TP degree (hymba's 25), S divides
        from repro_torch.models.layers import sequence_gather, sequence_shard
        q = sequence_shard(q)
    out = attention_full(q, k, v, cfg, window)
    if cfg.sequence_parallel:
        out = sequence_gather(out)
    return merge_last(out) @ p["wo"]


def gqa_prefill(p: Params, cfg, x: torch.Tensor,
                window: int) -> Tuple[torch.Tensor, Dict]:
    """Forward + return KV for the cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, torch.arange(S, device=x.device)[None, :])
    out = attention_full(q, k, v, cfg, window)
    return (merge_last(out) @ p["wo"],
            {"k": k, "v": v})


def gqa_decode(p: Params, cfg, x: torch.Tensor, cache: Dict, pos: int,
               window: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: [B,1,d]; cache k/v: [B,Smax,KV,hd]; pos: int.

    Writes the new key and value into ``cache`` in place (the reference
    returns an updated copy) and returns it: a decode step then moves one
    position of the cache, not all of it.
    """
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Smax = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, cfg, x,
                           torch.full((B, 1), pos, device=x.device))
    write_at(cache["k"], 1, pos, k_new[:, 0].to(cache["k"].dtype))
    write_at(cache["v"], 1, pos, v_new[:, 0].to(cache["v"].dtype))
    kr = _repeat_kv(cache["k"], H // KV)
    vr = _repeat_kv(cache["v"], H // KV)
    s = (torch.einsum("bqhd,bkhd->bhqk", q, kr).to(torch.float32)
         / math.sqrt(hd))
    kj = torch.arange(Smax, device=x.device)
    s = torch.where(_window_mask(torch.tensor(pos, device=x.device), kj,
                                 window), s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    out = merge_last(torch.einsum("bhqk,bkhd->bqhd", prob, vr))
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

def mla_init(generator: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(generator, d, m.q_lora_rank, dtype),
        "wq_b": dense_init(generator, m.q_lora_rank, H * qk, dtype),
        "wkv_a": dense_init(generator, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype),
        "wkv_b": dense_init(generator, m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "wo": dense_init(generator, H * m.v_head_dim, d, dtype),
    }


def _mla_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    H = cfg.n_heads
    q = split_last((x @ p["wq_a"]) @ p["wq_b"], H)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = torch.split(x @ p["wkv_a"],
                               [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                      # [B,S,1,rope]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(m) -> float:
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_forward(p: Params, cfg, x: torch.Tensor, window: int = 0,
                positions=None, return_cache: bool = False):
    """Full-sequence MLA (prefill, non-absorbed form).  Causal over the
    whole sequence: like the reference, it takes ``window`` and ignores
    it."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    kv = split_last(c_kv @ p["wkv_b"], H)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    if cfg.attention_impl == "chunked" and S % cfg.attention_chunk == 0:
        out = chunked_attention(q, k, v, causal=True, window=0,
                                chunk=cfg.attention_chunk)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
            * _mla_scale(m)
        idx = torch.arange(S, device=x.device)
        s = torch.where((idx[None, :] <= idx[:, None])[None, None], s,
                        NEG_INF)
        prob = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", prob, v)
    y = merge_last(out) @ p["wo"]
    if return_cache:
        return y, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
    return y


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Dict,
               pos: int) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form MLA decode: attends in the compressed latent space.

    cache: c_kv [B, Smax, kv_lora], k_rope [B, Smax, rope], written in
    place at ``pos`` (as :func:`gqa_decode` writes K and V) and returned.
    """
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    Smax = cache["c_kv"].shape[1]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(
        p, cfg, x, torch.full((B, 1), pos, device=x.device))
    write_at(cache["c_kv"], 1, pos, c_kv_new[:, 0].to(cache["c_kv"].dtype))
    write_at(cache["k_rope"], 1, pos,
             k_rope_new[:, 0, 0].to(cache["k_rope"].dtype))
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    # absorb wkv_b's K half into q: q_eff [B, 1, H, kv_lora]
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H,
                               m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[:, :, :m.qk_nope_head_dim]             # [lora, H, nope]
    w_uv = wkv_b[:, :, m.qk_nope_head_dim:]             # [lora, H, v]
    q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)
    s = (torch.einsum("bqhl,bkl->bhqk", q_eff, c_kv)
         + torch.einsum("bqhr,bkr->bhqk", q_rope, k_rope)).to(
             torch.float32) * _mla_scale(m)
    kj = torch.arange(Smax, device=x.device)
    s = torch.where(kj <= pos, s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkl->bqhl", prob, c_kv)     # latent context
    out = torch.einsum("bqhl,lhv->bqhv", ctx, w_uv)
    return merge_last(out) @ p["wo"], cache


def layer_windows(cfg) -> List[int]:
    """Per-layer attention window: 0 = global, w = sliding window."""
    if cfg.global_every and cfg.local_window:
        return [0 if (i + 1) % cfg.global_every == 0 else cfg.local_window
                for i in range(cfg.n_layers)]
    return [0] * cfg.n_layers

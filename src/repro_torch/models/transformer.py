"""Decoder assembly: init / prefill / decode for the ``attn``, ``hybrid``
and ``rwkv`` blocks.

Parameters keep the reference's tree: layers are stacked (leading axis =
layer) under ``params["layers"]``, with the reference's keys, shapes and
dtypes, so a reference checkpoint converts leaf for leaf
(:mod:`repro_torch.models.convert`).  The reference's ``lax.scan`` over
layers becomes a Python loop with one Python-int window per layer.

Blocks ported so far:

* ``attn``   — [pre-norm GQA] + [pre-norm SwiGLU];
* ``hybrid`` — parallel attention + Mamba heads, fused by per-branch norms
  (Hymba), then SwiGLU;
* ``rwkv``   — [pre-norm RWKV-6 time-mix] + [pre-norm channel-mix], with
  no attention and no KV cache (RWKV-6).

The other branches raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rwkv6
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Params, dtype_of, embed_init, mlp,
                                       mlp_init, rmsnorm, rmsnorm_init)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model branches the port does not run yet."""
    if cfg.block_type not in ("attn", "hybrid", "rwkv"):
        raise NotImplementedError(f"unknown block type {cfg.block_type!r}")
    if cfg.moe is not None and cfg.moe.n_experts:
        raise NotImplementedError(f"{cfg.arch_id}: MoE layers (ROADMAP "
                                  "item 6)")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.arch_id}: MLA attention (ROADMAP "
                                  "item 6)")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.arch_id}: the {cfg.frontend} "
                                  "frontend (ROADMAP item 6)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, generator.device
    p: Params = {"ln1": rmsnorm_init(d, torch.float32, dev),
                 "ln2": rmsnorm_init(d, torch.float32, dev)}
    if cfg.block_type == "rwkv":
        p["time"] = rwkv6.rwkv_time_init(generator, cfg, dtype)
        p["channel"] = rwkv6.rwkv_channel_init(generator, cfg, dtype)
        return p
    p["attn"] = attn.gqa_init(generator, cfg, dtype)
    if cfg.block_type == "hybrid":
        p["ssm"] = ssm_mod.ssm_init(generator, cfg, dtype)
        p["fuse_ln_a"] = rmsnorm_init(d, torch.float32, dev)
        p["fuse_ln_s"] = rmsnorm_init(d, torch.float32, dev)
    p["ffn"] = mlp_init(generator, d, cfg.d_ff, dtype)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters on ``device``, drawn from ``generator`` (which
    must live there; ``device=None`` takes the generator's).  The values
    differ from the reference's PRNG; the tree, shapes and dtypes are the
    reference's."""
    check_supported(cfg)
    want, have = torch.device(device or generator.device), generator.device
    if want.type != have.type or want.index not in (None, have.index):
        raise ValueError(f"the generator lives on {generator.device}, not "
                         f"on {device}")
    dtype = dtype_of(cfg.param_dtype)
    p: Params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "final_ln": rmsnorm_init(cfg.d_model, torch.float32,
                                 generator.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype)
    p["layers"] = _stack([_layer_init(cfg, generator)
                          for _ in range(cfg.n_layers)])
    return p


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: Params) -> int:
    return int(sum(x.numel() for x in _leaves(params)))


def _layer(tree, i: int):
    """Layer i's slice of a stacked [L, ...] tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# layer forward (full sequence, no cache)
# ---------------------------------------------------------------------------


def _block_full(cfg: ModelConfig, p: Params, x: torch.Tensor,
                window: int) -> Tuple[torch.Tensor, float]:
    """One layer, full sequence.  Returns (x, aux_loss)."""
    if cfg.block_type == "rwkv":
        y, _ = rwkv6.rwkv_time_forward(p["time"], cfg,
                                       rmsnorm(p["ln1"], x, cfg.rms_eps))
        x = x + y
        y, _ = rwkv6.rwkv_channel_forward(p["channel"], cfg,
                                          rmsnorm(p["ln2"], x, cfg.rms_eps))
        return x + y, 0.0
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    a = attn.gqa_forward(p["attn"], cfg, h, window)
    if cfg.block_type == "hybrid":
        s, _ = ssm_mod.ssm_forward(p["ssm"], cfg, h)
        x = x + _fuse(cfg, p, a, s)
    else:
        x = x + a
    h2 = rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + mlp(p["ffn"], h2), 0.0


def _fuse(cfg: ModelConfig, p: Params, a: torch.Tensor,
          s: torch.Tensor) -> torch.Tensor:
    """Hymba's fusion of the attention and SSM branches."""
    return 0.5 * (rmsnorm(p["fuse_ln_a"], a, cfg.rms_eps)
                  + rmsnorm(p["fuse_ln_s"], s, cfg.rms_eps))


def forward_hidden(params: Params, cfg: ModelConfig,
                   x: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """Embeddings -> final hidden states.  x: [B, S, d]."""
    check_supported(cfg)
    aux = 0.0
    for i, w in enumerate(attn.layer_windows(cfg)):
        x, a = _block_full(cfg, _layer(params["layers"], i), x, w)
        aux += a
    return rmsnorm(params["final_ln"], x, cfg.rms_eps), aux


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    check_supported(cfg)
    return params["embed"][batch["tokens"]]


def _unembed_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward returning last-position logits [B, V] and the
    final hidden states."""
    x = embed_inputs(params, cfg, batch)
    h, _ = forward_hidden(params, cfg, x)
    return h[:, -1] @ _unembed_matrix(params, cfg).T, h


# ---------------------------------------------------------------------------
# KV-cache / recurrent-state decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cpu") -> Params:
    """Stacked [L, ...] cache tree: K and V, and for the hybrid block the
    SSM state ``h`` [L, B, di, N] (float32) and ``conv`` [L, B, d_conv-1,
    di]; for the rwkv block only its recurrent state, ``tm_x`` and
    ``cm_x`` [L, B, d] and ``wkv`` [L, B, H, n, n] (float32)."""
    check_supported(cfg)
    L = cfg.n_layers
    if cfg.block_type == "rwkv":
        st = rwkv6.rwkv_init_state(cfg, batch, dtype_of(cfg.activ_dtype),
                                   device)
        return {key: val.expand((L,) + val.shape).contiguous()
                for key, val in st.items()}
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype_of(cfg.activ_dtype)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.block_type == "hybrid":
        st = ssm_mod.ssm_init_state(cfg, batch, dtype, device)
        for key, val in st.items():
            cache[key] = val.expand((L,) + val.shape).contiguous()
    return cache


def _block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict,
                  pos: int, window: int) -> Tuple[torch.Tensor, Dict]:
    """One layer, one token.  cache: this layer's slice (updated in
    place)."""
    if cfg.block_type == "rwkv":
        y, st = rwkv6.rwkv_time_forward(p["time"], cfg,
                                        rmsnorm(p["ln1"], x, cfg.rms_eps),
                                        cache)
        cache["tm_x"].copy_(st["tm_x"])
        cache["wkv"].copy_(st["wkv"])
        x = x + y
        y, st = rwkv6.rwkv_channel_forward(p["channel"], cfg,
                                           rmsnorm(p["ln2"], x, cfg.rms_eps),
                                           cache)
        cache["cm_x"].copy_(st["cm_x"])
        return x + y, cache
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    y, _ = attn.gqa_decode(p["attn"], cfg, h, cache, pos, window)
    if cfg.block_type == "hybrid":
        s, st = ssm_mod.ssm_forward(p["ssm"], cfg, h,
                                    {"h": cache["h"], "conv": cache["conv"]})
        cache["h"].copy_(st["h"])
        cache["conv"].copy_(st["conv"])
        y = _fuse(cfg, p, y, s)
    x = x + y
    h2 = rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + mlp(p["ffn"], h2), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Params]:
    """One decoding step.

    tokens: [B, 1] integer ids; cache: stacked [L, ...] tree, written in
    place at ``pos`` (each layer's slice is a view of it); pos: the
    current position.  Returns (logits [B, V], the same cache).
    """
    check_supported(cfg)
    x = params["embed"][tokens].to(dtype_of(cfg.activ_dtype))
    for i, w in enumerate(attn.layer_windows(cfg)):
        x, _ = _block_decode(cfg, _layer(params["layers"], i), x,
                             _layer(cache, i), pos, w)
    h = rmsnorm(params["final_ln"], x, cfg.rms_eps)
    return h[:, 0] @ _unembed_matrix(params, cfg).T, cache

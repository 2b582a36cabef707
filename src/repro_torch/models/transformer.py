"""Decoder assembly: init / prefill / decode for all ten architectures.

Parameters keep the reference's tree: layers are stacked (leading axis =
layer) under ``params["layers"]``, with the reference's keys, shapes and
dtypes, and a MoE config's leading dense layers are a list of unstacked
layer trees under ``params["dense_layers"]``, so a reference checkpoint
converts leaf for leaf (:mod:`repro_torch.models.convert`).  The
reference's ``lax.scan`` over layers becomes a Python loop with one
Python-int window per layer.  Block types:

* ``attn``   — [pre-norm GQA | MLA] + [pre-norm SwiGLU | MoE];
* ``hybrid`` — parallel attention + Mamba heads, fused by per-branch norms
  (Hymba), then SwiGLU or MoE;
* ``rwkv``   — [pre-norm RWKV-6 time-mix] + [pre-norm channel-mix], with
  no attention and no KV cache (RWKV-6).

Frontends (:mod:`repro_torch.models.stubs`): ``audio`` reads frame
embeddings and predicts every codebook, ``vision`` prepends projected
patch embeddings to the text.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import stubs
from repro_torch.models.layers import (Params, dtype_of, embed_init, mlp,
                                       mlp_init, rmsnorm, rmsnorm_init)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations the reference itself cannot run."""
    if cfg.block_type not in ("attn", "hybrid", "rwkv"):
        raise NotImplementedError(f"unknown block type {cfg.block_type!r}")
    if cfg.block_type == "hybrid" and cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: a hybrid block with MLA attention; the "
            "reference's hybrid block runs GQA over the MLA weights and "
            "cannot run it either")


def _n_dense(cfg: ModelConfig) -> int:
    """Leading dense-FFN layers, kept apart from the stacked ones."""
    return cfg.moe.first_dense_layers if cfg.moe else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(cfg: ModelConfig, generator: torch.Generator,
                moe_layer: bool) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, generator.device
    p: Params = {"ln1": rmsnorm_init(d, torch.float32, dev),
                 "ln2": rmsnorm_init(d, torch.float32, dev)}
    if cfg.block_type == "rwkv":
        p["time"] = rwkv6.rwkv_time_init(generator, cfg, dtype)
        p["channel"] = rwkv6.rwkv_channel_init(generator, cfg, dtype)
        return p
    if cfg.mla is not None:
        p["attn"] = attn.mla_init(generator, cfg, dtype)
    else:
        p["attn"] = attn.gqa_init(generator, cfg, dtype)
    if cfg.block_type == "hybrid":
        p["ssm"] = ssm_mod.ssm_init(generator, cfg, dtype)
        p["fuse_ln_a"] = rmsnorm_init(d, torch.float32, dev)
        p["fuse_ln_s"] = rmsnorm_init(d, torch.float32, dev)
    if moe_layer:
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype)
    else:
        p["ffn"] = mlp_init(generator, d, cfg.d_ff, dtype)
    return p


def _stacked(n: int, draw) -> Params:
    """``n`` trees from ``draw()`` stacked leaf by leaf into [n, ...]
    buffers, each tree copied in as it is drawn: the peak is the stack
    and one layer, not twice the stack."""
    first = draw()

    def alloc(tree):
        if isinstance(tree, dict):
            return {k: alloc(v) for k, v in tree.items()}
        return tree.new_empty((n,) + tuple(tree.shape))

    def put(buf, tree, i):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(buf[k], v, i)
        else:
            buf[i].copy_(tree)

    out = alloc(first)
    if n:
        put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, draw(), i)
    return out


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
    n_dense = _n_dense(cfg)
    moe_layer = cfg.moe is not None and cfg.moe.n_experts > 0
    p: Params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "final_ln": rmsnorm_init(cfg.d_model, torch.float32,
                                 generator.device),
    }
    if not cfg.tie_embeddings and cfg.frontend != "audio":
        p["lm_head"] = embed_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype)
    p["layers"] = _stacked(cfg.n_layers - n_dense,
                           lambda: _layer_init(cfg, generator, moe_layer))
    if n_dense:
        p["dense_layers"] = [_layer_init(cfg, generator, moe_layer=False)
                             for _ in range(n_dense)]
    if cfg.frontend == "audio":
        p["audio"] = stubs.audio_head_init(generator, cfg, dtype)
    if cfg.frontend == "vision":
        p["vision"] = stubs.vision_proj_init(generator, cfg, dtype)
    return p


def _leaves(tree):
    if isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: Params) -> int:
    return int(sum(x.numel() for x in _leaves(params)))


def _layer(tree, i: int):
    """Layer i's slice of a stacked [L, ...] tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layer(v, i) for v in tree]
    return tree[i]


# ---------------------------------------------------------------------------
# layer forward (full sequence, no cache)
# ---------------------------------------------------------------------------


def _block_full(cfg: ModelConfig, p: Params, x: torch.Tensor,
                window: int) -> Tuple[torch.Tensor, torch.Tensor | float]:
    """One layer, full sequence.  Returns (x, aux_loss)."""
    if cfg.block_type == "rwkv":
        y, _ = rwkv6.rwkv_time_forward(p["time"], cfg,
                                       rmsnorm(p["ln1"], x, cfg.rms_eps))
        x = x + y
        y, _ = rwkv6.rwkv_channel_forward(p["channel"], cfg,
                                          rmsnorm(p["ln2"], x, cfg.rms_eps))
        return x + y, 0.0
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    if cfg.mla is not None:
        a = attn.mla_forward(p["attn"], cfg, h, window)
    else:
        a = attn.gqa_forward(p["attn"], cfg, h, window)
    if cfg.block_type == "hybrid":
        s, _ = ssm_mod.ssm_forward(p["ssm"], cfg, h)
        x = x + _fuse(cfg, p, a, s)
    else:
        x = x + a
    return _ffn(p, cfg, x)


def _ffn(p: Params, cfg: ModelConfig,
         x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor | float]:
    """The residual FFN half of a block: SwiGLU, or MoE with its aux
    loss."""
    h2 = rmsnorm(p["ln2"], x, cfg.rms_eps)
    if "moe" in p:
        y, aux = moe_mod.moe_forward(p["moe"], cfg, h2)
        return x + y, aux
    return x + mlp(p["ffn"], h2), 0.0


def _fuse(cfg: ModelConfig, p: Params, a: torch.Tensor,
          s: torch.Tensor) -> torch.Tensor:
    """Hymba's fusion of the attention and SSM branches."""
    return 0.5 * (rmsnorm(p["fuse_ln_a"], a, cfg.rms_eps)
                  + rmsnorm(p["fuse_ln_s"], s, cfg.rms_eps))


def forward_hidden(params: Params, cfg: ModelConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor | float]:
    """Embeddings -> final hidden states.  x: [B, S, d].  The leading
    dense layers run first, then the stacked ones; the aux loss sums the
    stacked layers' (as the reference's scan does)."""
    check_supported(cfg)
    windows = attn.layer_windows(cfg)
    n_dense = _n_dense(cfg)
    for i in range(n_dense):
        x, _ = _block_full(cfg, params["dense_layers"][i], x, windows[i])
    aux = 0.0
    for i, w in enumerate(windows[n_dense:]):
        x, a = _block_full(cfg, _layer(params["layers"], i), x, w)
        aux = aux + a
    return rmsnorm(params["final_ln"], x, cfg.rms_eps), aux


# ---------------------------------------------------------------------------
# embedding / unembedding per modality
# ---------------------------------------------------------------------------


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``batch["frames"]`` for audio; ``batch["tokens"]``' embeddings
    otherwise, behind ``batch["vision_embeds"]`` for vision."""
    check_supported(cfg)
    if cfg.frontend == "audio":
        return batch["frames"].to(dtype_of(cfg.activ_dtype))
    x = params["embed"][batch["tokens"]]
    if cfg.frontend == "vision":
        x = stubs.vision_prepend(params["vision"],
                                 batch["vision_embeds"].to(x.dtype), x)
    return x


def _unembed_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _logits(params: Params, cfg: ModelConfig,
            h: torch.Tensor) -> torch.Tensor:
    """h: [B, d] -> [B, V], or [B, K, V] over the audio codebooks."""
    if cfg.frontend == "audio":
        return stubs.audio_logits(params["audio"], h[:, None])[:, 0]
    return h @ _unembed_matrix(params, cfg).T


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward returning last-position logits ([B, V], or
    [B, K, V] for audio) and the final hidden states."""
    x = embed_inputs(params, cfg, batch)
    h, _ = forward_hidden(params, cfg, x)
    return _logits(params, cfg, h[:, -1]), h


# ---------------------------------------------------------------------------
# KV-cache / recurrent-state decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cpu") -> Params:
    """Stacked [L, ...] cache tree over all layers (the dense ones first):
    K and V [L, B, Smax, KV, hd], or for MLA ``c_kv`` [L, B, Smax,
    kv_lora] and ``k_rope`` [L, B, Smax, rope]; for the hybrid block also
    the SSM state ``h`` [L, B, di, N] (float32) and ``conv`` [L, B,
    d_conv-1, di]; for the rwkv block only its recurrent state, ``tm_x``
    and ``cm_x`` [L, B, d] and ``wkv`` [L, B, H, n, n] (float32)."""
    check_supported(cfg)
    L = cfg.n_layers
    dtype = dtype_of(cfg.activ_dtype)
    if cfg.block_type == "rwkv":
        st = rwkv6.rwkv_init_state(cfg, batch, dtype, device)
        return {key: val.expand((L,) + val.shape).contiguous()
                for key, val in st.items()}
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"c_kv": (L, batch, max_seq, m.kv_lora_rank),
                  "k_rope": (L, batch, max_seq, m.qk_rope_head_dim)}
    else:
        kv = (L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": kv, "v": kv}
    cache = {key: torch.zeros(shape, dtype=dtype, device=device)
             for key, shape in shapes.items()}
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
    if cfg.mla is not None:
        y, _ = attn.mla_decode(p["attn"], cfg, h, cache, pos)
    else:
        y, _ = attn.gqa_decode(p["attn"], cfg, h, cache, pos, window)
    if cfg.block_type == "hybrid":
        s, st = ssm_mod.ssm_forward(p["ssm"], cfg, h,
                                    {"h": cache["h"], "conv": cache["conv"]})
        cache["h"].copy_(st["h"])
        cache["conv"].copy_(st["conv"])
        y = _fuse(cfg, p, y, s)
    x, _ = _ffn(p, cfg, x + y)
    return x, cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Params]:
    """One decoding step.

    tokens: [B, 1] integer ids ([B, 1, K] over the audio codebooks);
    cache: stacked [L, ...] tree, written in place at ``pos`` (each
    layer's slice is a view of it; the dense layers' come first); pos:
    the current position.  Returns (logits [B, V] or [B, K, V], the same
    cache).
    """
    check_supported(cfg)
    if cfg.frontend == "audio":
        x = stubs.audio_embed_tokens(params["audio"], tokens)
    else:
        x = params["embed"][tokens]
    x = x.to(dtype_of(cfg.activ_dtype))
    windows = attn.layer_windows(cfg)
    n_dense = _n_dense(cfg)
    for i, w in enumerate(windows):
        p = (params["dense_layers"][i] if i < n_dense
             else _layer(params["layers"], i - n_dense))
        x, _ = _block_decode(cfg, p, x, _layer(cache, i), pos, w)
    h = rmsnorm(params["final_ln"], x, cfg.rms_eps)
    return _logits(params, cfg, h[:, 0]), cache

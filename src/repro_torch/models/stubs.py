"""Modality-frontend stubs, as the reference's ``models/stubs.py``: the
transformer backbone is real, the frontend's output arrives precomputed
in the batch.

* audio (musicgen-large): EnCodec frame embeddings arrive as
  ``batch["frames"]`` [B, S, d_model]; the backbone owns per-codebook
  unembedding heads and (for decode) per-codebook token embeddings that
  are summed.
* vision (internvl2-26b): ViT patch embeddings arrive as
  ``batch["vision_embeds"]`` [B, n_vision_tokens, d_model] and are
  prepended to the text embeddings behind a learned projection.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import Params, dense_init, embed_init


def audio_head_init(generator: torch.Generator, cfg,
                    dtype: torch.dtype) -> Params:
    K, V, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    return {
        "codebook_embed": torch.stack(
            [embed_init(generator, V, d, dtype) for _ in range(K)]),
        "codebook_head": torch.stack(
            [embed_init(generator, V, d, dtype) for _ in range(K)]),
    }


def audio_embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S, n_codebooks] -> summed embeddings [B, S, d], added
    codebook by codebook in the table's dtype."""
    table = p["codebook_embed"]
    out = table[0][tokens[..., 0]]
    for i in range(1, table.shape[0]):
        out = out + table[i][tokens[..., i]]
    return out


def audio_logits(p: Params, h: torch.Tensor) -> torch.Tensor:
    """h: [B, S, d] -> [B, S, n_codebooks, V]."""
    return torch.einsum("bsd,kvd->bskv", h, p["codebook_head"])


def vision_proj_init(generator: torch.Generator, cfg,
                     dtype: torch.dtype) -> Params:
    return {"proj": dense_init(generator, cfg.d_model, cfg.d_model, dtype)}


def vision_prepend(p: Params, vis_embeds: torch.Tensor,
                   txt_embeds: torch.Tensor) -> torch.Tensor:
    """vis: [B, Nv, d] (the stub frontend's output), txt: [B, S, d] ->
    [B, Nv + S, d]."""
    return torch.cat([vis_embeds @ p["proj"], txt_embeds], dim=1)

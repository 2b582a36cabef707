"""Step builders for serving (prefill and decode), closed over a
:class:`ModelConfig` as in the reference.

The train step waits for a backward pass: no kernel of the reference has
one (ROADMAP item 6.5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits [B, V] ([B, K, V] for
    audio).  ``batch`` holds ``tokens`` [B, S], with ``vision_embeds``
    [B, Nv, d] for vision, or ``frames`` [B, S, d] for audio.  On the card
    every GQA layer's attention is one launch of the flash kernel, every
    hybrid layer's SSM scan one launch of the selective-scan kernel, and
    every rwkv layer's WKV recurrence one launch of the wkv6 kernel; MLA
    and MoE layers are plain tensor code, as in the reference."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = T.prefill(params, cfg, batch)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, cache, tokens [B, 1], pos) -> (greedy next tokens [B]
    int32, cache).  The cache is updated in place."""

    @torch.no_grad()
    def decode_one(params, cache, tokens, pos):
        logits, cache = T.decode_step(params, cfg, cache, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode_one

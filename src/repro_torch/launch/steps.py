"""Step builders (train, prefill, decode), closed over a
:class:`ModelConfig` as in the reference.

The train step differentiates ``T.model_loss`` with autograd where the
reference uses ``jax.value_and_grad``: on the card every GQA layer's
attention runs the flash forward kernel and, in backward, the flash
backward kernel, every ``hybrid`` layer's SSM scan the selective-scan
forward kernel and, in backward, its backward kernel, and every ``rwkv``
layer's WKV recurrence the wkv6 forward kernel and, in backward, its
backward kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     tree_leaves, tree_map)


def _loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, grads): the loss detached, the gradients in the parameters'
    tree and types; a parameter the loss does not read gets zeros, as
    jax gives it."""
    held = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(held)
    loss = T.model_loss(held, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], held)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics{loss,
    grad_norm, lr}).

    ``grad_accum`` > 1 splits the batch into microbatches as the
    reference's reshape-and-swapaxes does (microbatch j holds rows j,
    j + accum, ...) and sums their float32 gradients in that order, then
    divides by ``grad_accum``, as its scan does.  The optimizer state's
    moments are updated in place (:func:`adamw_update`)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(params, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        if grad_accum == 1:
            loss, grads = _loss_and_grads(cfg, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{grad_accum} microbatches")
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=opt_state.step.device)
            gsum = tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device), params)
            for j in range(grad_accum):
                mb = {k: v[j::grad_accum].contiguous()
                      for k, v in batch.items()}
                l, g = _loss_and_grads(cfg, params, mb)
                tree_map(lambda a, b: a.add_(b.to(torch.float32)), gsum, g)
                loss_sum = loss_sum + l
            loss = loss_sum / grad_accum
            grads = tree_map(lambda g: g / grad_accum, gsum)
        new_params, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                                    opt_state)
        return new_params, new_opt, {"loss": loss, **metrics}

    return train_step


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

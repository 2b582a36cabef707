"""Step builders (train, prefill, decode), closed over a
:class:`ModelConfig` as in the reference, and the abstract input specs
the dry run places on a mesh.

The train step differentiates ``T.model_loss`` with autograd where the
reference uses ``jax.value_and_grad``: on the card every GQA layer's
attention runs the flash forward kernel and, in backward, the flash
backward kernel, every ``hybrid`` layer's SSM scan the selective-scan
forward kernel and, in backward, its backward kernel, and every ``rwkv``
layer's WKV recurrence the wkv6 forward kernel and, in backward, its
backward kernel.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, ContextManager, Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.compat import mesh_context
from repro_torch.distributed.meshes import (from_submesh, microbatch_mesh,
                                           replicate_dim, split_dim,
                                           to_submesh)
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


# A counting context that takes a loop's trips as one trip counted n times
# (the dry run's ``launch/dryrun._Counter``, as the reference's cost model
# multiplies a scan body by its known trip count) sets this for its block:
# a callable n -> context manager, entered around the one trip that runs.
# Unset, as everywhere else, a loop runs every trip.
_TRIP_COUNTER: contextvars.ContextVar[
    Optional[Callable[[int], ContextManager]]] = contextvars.ContextVar(
        "trip_counter", default=None)


@contextlib.contextmanager
def counting_trips(repeat: Callable[[int], ContextManager]):
    """For the block, each loop of a step runs its first trip only, inside
    ``repeat(trips)``, which counts what that trip dispatches ``trips``
    times.  Every trip has the same shapes and placements, so a counter's
    totals are those of running them all."""
    token = _TRIP_COUNTER.set(repeat)
    try:
        yield
    finally:
        _TRIP_COUNTER.reset(token)


def _microbatch_grads(cfg: ModelConfig, params, mb, sub):
    """:func:`_loss_and_grads` of one microbatch, on the sub-mesh ``sub``
    where it is not ``None`` (:func:`microbatch_mesh`): the parameters and
    the microbatch moved onto it, the rows sharded over "data", and the
    gradients moved back."""
    if sub is None:
        return _loss_and_grads(cfg, params, mb)
    from torch.distributed.tensor import Replicate, Shard

    mesh = next(iter(mb.values())).device_mesh
    rows = [Shard(0) if n == "data" else Replicate()
            for n in sub.mesh_dim_names]
    mb = {k: v.redistribute(sub, rows)
          for k, v in to_submesh(mb, sub).items()}
    with mesh_context(sub):
        loss, grads = _loss_and_grads(cfg, to_submesh(params, sub), mb)
    return from_submesh(loss, mesh), from_submesh(grads, mesh)


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
            # zeros placed as each parameter is (a DTensor's placement,
            # on a mesh), so that the in-place sums stay where it is
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
            sub = microbatch_mesh(next(iter(batch.values())),
                                  B // grad_accum)
            repeat = _TRIP_COUNTER.get()
            for j in range(grad_accum if repeat is None else 1):
                with (contextlib.nullcontext() if repeat is None
                      else repeat(grad_accum)):
                    # rows j, j + accum, ... through a reshape of the
                    # leading dim, which keeps a batch sharded on it
                    # sharded (a strided slice of a sharded dim would
                    # gather it) where its shards hold whole groups of
                    # accum rows
                    mb = {k: split_dim(v, 0, B // grad_accum)[:, j]
                          .contiguous() for k, v in batch.items()}
                    l, g = _microbatch_grads(cfg, params, mb, sub)
                    tree_map(lambda a, b: a.add_(b.to(torch.float32)),
                             gsum, g)
                    loss_sum = loss_sum + l
                    # a trip's microbatch and gradients are freed before
                    # the next is made, so every trip peaks alike
                    del mb, l, g
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
        # on a mesh, the vocab gathered whole: DTensor's argmax over a dim
        # that two mesh axes shard returns wrong-shaped indices
        logits = replicate_dim(logits, -1)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode_one


# ---------------------------------------------------------------------------
# abstract input specs
# ---------------------------------------------------------------------------
#
# The reference's ``jax.ShapeDtypeStruct`` trees become tensors with no
# storage: ``meta`` tensors, or, where the caller passes a
# ``FakeTensorMode``, fake tensors of that mode on the CPU, which DTensor
# can place on a CPU mesh.  Keys, shapes and dtypes are the reference's.


def _spec(shape, dtype, fake_mode) -> torch.Tensor:
    if fake_mode is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    with fake_mode:
        return torch.empty(shape, dtype=dtype)


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                fake_mode=None) -> Dict[str, Any]:
    """Stand-ins for the data batch of a train/prefill step."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.frontend == "audio":
        return {"frames": _spec((B, S, cfg.d_model), bf16, fake_mode),
                "labels": _spec((B, S, cfg.n_codebooks), i32, fake_mode)}
    if cfg.frontend == "vision":
        return {"tokens": _spec((B, S), i32, fake_mode),
                "vision_embeds": _spec((B, cfg.n_vision_tokens, cfg.d_model),
                                       bf16, fake_mode)}
    return {"tokens": _spec((B, S), i32, fake_mode)}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 fake_mode=None) -> Dict[str, Any]:
    """Inputs for one decode step with a seq_len-deep cache."""
    B, S = shape.global_batch, shape.seq_len
    with fake_mode or contextlib.nullcontext():
        cache = T.init_cache(cfg, B, S,
                             device="cpu" if fake_mode else "meta")
    tok = (B, 1, cfg.n_codebooks) if cfg.frontend == "audio" else (B, 1)
    return {"cache": cache, "tokens": _spec(tok, torch.int32, fake_mode),
            "pos": _spec((), torch.int32, fake_mode)}


def param_specs(cfg: ModelConfig, seed: int = 0, fake_mode=None) -> Any:
    """The parameter tree's shapes and dtypes.  ``T.init_params`` runs
    under a ``FakeTensorMode`` (the caller's, or one of its own whose
    leaves come back as ``meta`` tensors), so no weight is drawn and no
    storage is allocated: a 236e9-parameter tree costs nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = fake_mode or FakeTensorMode()
    with mode:
        tree = T.init_params(cfg, torch.Generator().manual_seed(seed))
    return tree if fake_mode is not None else _to_meta(tree)


def abstract_opt_state(params_spec, fake_mode=None) -> OptState:
    f32 = lambda p: _spec(p.shape, torch.float32, fake_mode)  # noqa: E731
    return OptState(mu=tree_map(f32, params_spec),
                    nu=tree_map(f32, params_spec),
                    step=_spec((), torch.int32, fake_mode))


def input_specs(arch_or_cfg, shape_name: str,
                fake_mode=None) -> Dict[str, Any]:
    """Every model input for (arch, shape) as tensors with no storage."""
    from repro_torch.configs.base import get_config
    cfg = arch_or_cfg if isinstance(arch_or_cfg, ModelConfig) \
        else get_config(arch_or_cfg)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        return decode_specs(cfg, shape, fake_mode)
    return batch_specs(cfg, shape, fake_mode)

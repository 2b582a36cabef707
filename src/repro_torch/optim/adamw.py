"""AdamW + cosine schedule + global-norm clipping over trees of tensors
(dicts, lists and tuples), the reference's ``repro/optim/adamw.py``: no
``torch.optim``, the reference's arithmetic in its order.

The moments are float32 whatever the parameters' type (mixed-precision
master moments), gradients are cast to float32 before clipping, the clip
scale is cast to the gradient's type, ``step + 1`` feeds the schedule, and
each update is cast back to its parameter's type.  Where the reference
builds new moment trees, :func:`adamw_update` writes the same values into
the state's moment tensors in place and walks the tree a leaf at a time,
so a step holds one leaf's temporaries and not a second copy of every
moment.  The reference's ZeRO-1 sharding of the moments over a ``data``
mesh axis is a sharding rule, ``distributed/meshes.opt_pspecs``, applied
where the state is placed on a mesh; the update is the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor          # int32 scalar


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest``, keeping ``tree``'s structure (an ``OptState`` stays
    one)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(type(tree), "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in jax's order: dict keys sorted, sequences by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac·lr``,
    as a float32 scalar on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).  The
    returned state holds ``state``'s moment tensors, updated in place; the
    parameters are new tensors."""
    f32 = torch.float32
    gnorm = global_norm(grads)          # of the float32-cast gradients
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.clip_norm > 0 else None)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(f32)
    bc2 = 1 - b2 ** step.to(f32)

    def upd(p, g, m, n):
        g = g.to(f32)
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_((1 - b1) * g)           # b1 * m + (1 - b1) * g
        n.mul_(b2).add_((1 - b2) * g * g)       # b2 * n + (1 - b2) * g * g
        mhat = m / bc1
        nhat = n / bc2
        p32 = p.to(f32)
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, grads, state.mu, state.nu)
    return (new_params, OptState(state.mu, state.nu, step),
            {"grad_norm": gnorm, "lr": lr})

"""Token-choice top-k Mixture-of-Experts with capacity-factor dispatch, as
the reference's ``models/moe.py``.

* Tokens stay grouped by batch row (group = sequence): router, ranking and
  dispatch are per group, so capacity is per group,
  ``C = max(8, ceil8(ceil(S * top_k / E * capacity_factor)))``.
* A slot is one of a token's ``top_k`` choices.  Slots are ranked within
  their expert in slot-major order (token by token, choice by choice);
  a slot ranked ``C`` or later is dropped, exactly as in the reference.
* Dispatch fills compact ``[E, C]`` index and weight buffers (empty
  entries point at token 0 with weight 0); the experts run as batched
  matmuls over ``[E, B*C, d]``.
* The combine sums each token's kept slots in a fixed order (ascending
  expert, the order of the reference's scatter-add over its ``E*C``
  entries) through a slot table, not through ``index_add_``, whose atomic
  adds on CUDA would reorder bf16 sums from run to run.

The reference computes all of this outside any Pallas kernel, and so
does the port: plain tensor code on either device.  Its expert-sharding
constraint is a mesh hint with no meaning on one device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, mlp, mlp_init


def _expert_shard(x_t: torch.Tensor) -> torch.Tensor:
    """Sharding hint for [E, B, C, d] (expert-major) dispatch tensors: E on
    the expert-parallel axis ("data"), matching the expert weights.  Under
    a mesh context a DTensor on the ambient mesh is redistributed to it;
    outside one, on a plain tensor, or where E does not divide, ``x_t``
    comes back as it is."""
    from repro_torch.core.compat import axis_sizes, get_abstract_mesh
    from repro_torch.distributed.meshes import P, constrain

    mesh = get_abstract_mesh()
    if mesh is None or "data" not in axis_sizes(mesh):
        return x_t
    if x_t.shape[0] % axis_sizes(mesh)["data"] != 0:
        return x_t
    return constrain(x_t, P("data", None, None, None))


def moe_capacity(seq_len: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = math.ceil(seq_len * top_k / n_experts * capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def moe_init(generator: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    mc = cfg.moe
    d = cfg.d_model
    ff = mc.expert_d_ff or cfg.d_ff
    E = mc.n_experts
    dev = generator.device

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev)

    p = {
        "router": dense_init(generator, d, E, torch.float32),
        "w_gate": (randn(E, d, ff) / math.sqrt(d)).to(dtype),
        "w_up": (randn(E, d, ff) / math.sqrt(d)).to(dtype),
        "w_down": (randn(E, ff, d) / math.sqrt(ff)).to(dtype),
    }
    if mc.n_shared:
        p["shared"] = mlp_init(generator, d, ff * mc.n_shared, dtype)
    return p


class Routing(NamedTuple):
    """Where each slot goes.  Slots are flattened slot-major, [B, S*K]."""
    expert: torch.Tensor      # expert id of each slot
    position: torch.Tensor    # its rank within the expert, in its group
    keep: torch.Tensor        # position < capacity
    gate: torch.Tensor        # renormalised top-k weight (float32)
    capacity: int
    aux: torch.Tensor         # the switch-style load-balance loss

    @property
    def dropped(self) -> torch.Tensor:
        """Slots past capacity, summed over the batch (a device scalar)."""
        return (~self.keep).sum()


def route(p: Params, cfg, x: torch.Tensor) -> Routing:
    """Router, top-k, aux loss and slot-major ranking for x [B, S, d]."""
    mc = cfg.moe
    B, S, _ = x.shape
    E, K = mc.n_experts, mc.top_k
    C = moe_capacity(S, E, K, mc.capacity_factor)

    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)               # [B, S, K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=(0, 1))                               # [E]
    ce = F.one_hot(expert[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce) * mc.router_aux_coef

    expert = expert.reshape(B, S * K)
    onehot = F.one_hot(expert, E)                             # [B, S*K, E]
    before = torch.cumsum(onehot, dim=1) - onehot             # rank before self
    position = torch.gather(before, 2, expert[..., None])[..., 0]
    return Routing(expert, position, position < C, gate.reshape(B, S * K),
                   C, aux)


def moe_forward(p: Params, cfg, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss).  Group axis = B."""
    mc = cfg.moe
    B, S, d = x.shape
    E, K = mc.n_experts, mc.top_k
    r = route(p, cfg, x)
    C = r.capacity

    # -- compact dispatch buffers: column C collects the dropped slots --
    flat = torch.where(r.keep, r.expert * (C + 1) + r.position, C)
    token_of_slot = (torch.arange(S * K, device=x.device) // K).expand(B, -1)
    # out-of-place scatters into fresh zeros: on a mesh the buffers take
    # the routing's (batch-sharded) placement
    idx = torch.zeros((B, E * (C + 1)), dtype=torch.long,
                      device=x.device).scatter(1, flat, token_of_slot)
    w = torch.zeros((B, E * (C + 1)), dtype=torch.float32,
                    device=x.device).scatter(
                        1, flat, torch.where(r.keep, r.gate, 0.0))
    idx = idx.view(B, E, C + 1)[:, :, :C].reshape(B, E * C)
    w = w.view(B, E, C + 1)[:, :, :C]

    # -- gather -> expert SwiGLU -> weight -----------------------------------
    x_e = torch.gather(x, 1, idx[..., None].expand(-1, -1, d))  # [B, E*C, d]
    # token -> expert routing as a transpose of the two sharded dims,
    # (B@data, E, C, d) -> (E@data, B, C, d), hinted where each crosses
    x_t = _expert_shard(x_e.view(B, E, C, d).transpose(0, 1))
    x_t = x_t.reshape(E, B * C, d)
    h = F.silu(torch.bmm(x_t, p["w_gate"])) * torch.bmm(x_t, p["w_up"])
    y_t = _expert_shard(torch.bmm(h, p["w_down"]).view(E, B, C, d))
    y_e = y_t.transpose(0, 1)
    y_e = (y_e * w[..., None].to(y_e.dtype)).reshape(B, E * C, d)

    # -- combine: each token's kept slots, by ascending expert ---------------
    expert = r.expert.view(B, S, K)
    order = torch.argsort(expert, dim=-1)
    slot = torch.where(r.keep, r.expert * C + r.position, 0).view(B, S, K)
    slot = torch.gather(slot, 2, order)
    keep = torch.gather(r.keep.view(B, S, K), 2, order)
    y = torch.zeros((B, S, d), dtype=y_e.dtype, device=x.device)
    for k in range(K):
        part = torch.gather(y_e, 1, slot[..., k, None].expand(-1, -1, d))
        y = y + torch.where(keep[..., k, None], part, 0)

    if mc.n_shared:
        y = y + mlp(p["shared"], x)
    return y.to(x.dtype), r.aux

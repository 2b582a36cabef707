"""Explicit collective schedules on ``torch.distributed``, the reference's
``repro/distributed/collectives.py``.

Each rank calls these SPMD with its own shard, inside a
:func:`repro_torch.core.compat.mesh_context`; an axis name resolves to the
process group of that dimension of the ambient mesh, as a ``shard_map``
axis does in the reference.  Inputs are not modified.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.compat import axis_size as _axis_size
from repro_torch.core.compat import get_abstract_mesh


def _group(axis_name: str):
    """(process group, this rank's index along the axis) on the ambient
    mesh."""
    mesh = get_abstract_mesh()
    _axis_size(axis_name)                    # raises outside a mesh context
    return mesh.get_group(axis_name), mesh.get_local_rank(axis_name)


def ring_all_gather(x: torch.Tensor, axis_name: str,
                    compute: Optional[Callable[[torch.Tensor, int], None]]
                    = None) -> torch.Tensor:
    """All-gather along ``axis_name`` by N-1 ring hops: each hop sends the
    shard last received to rank i+1 and receives from rank i-1
    (``batch_isend_irecv``).  ``compute(shard, slot)`` is called with each
    shard as it arrives (the overlap hook: the next hop is already in
    flight), ``slot`` being its owner's index along the axis.  Returns the
    shards in global order, concatenated on the leading dimension (stacked
    for a 0-d ``x``), as the reference's rotation does."""
    import torch.distributed as dist

    n = _axis_size(axis_name)
    group, idx = _group(axis_name)
    to = dist.get_global_rank(group, (idx + 1) % n)
    frm = dist.get_global_rank(group, (idx - 1) % n)
    out = [None] * n
    out[idx] = x
    cur = x.contiguous()
    for hop in range(1, n):
        nxt = torch.empty_like(cur)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, to, group),
            dist.P2POp(dist.irecv, nxt, frm, group)])
        for r in reqs:
            r.wait()
        cur = nxt
        # device i received the shard of i - hop
        slot = (idx - hop) % n
        out[slot] = cur
        if compute is not None:
            compute(cur, slot)
    if x.dim() == 0:
        return torch.stack(out)
    return torch.cat(out, dim=0)


def reduce_scatter_sum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum over ``axis_name``, scattered along the leading dimension
    (tiled: rank i keeps rows [i·m/N, (i+1)·m/N) of the sum)."""
    import torch.distributed as dist

    n = _axis_size(axis_name)
    group, _ = _group(axis_name)
    if x.shape[0] % n:
        raise ValueError(f"leading dimension {x.shape[0]} does not divide "
                         f"over {n} ranks of {axis_name!r}")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def hierarchical_psum(x: torch.Tensor, inner: str,
                      outer: Optional[str]) -> torch.Tensor:
    """Two-level gradient sum: ``all_reduce`` inside ``inner`` first (the
    fast links), then across ``outer`` when it is given."""
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_group(inner)[0])
    if outer is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_group(outer)[0])
    return x

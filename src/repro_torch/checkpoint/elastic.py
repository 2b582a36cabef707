"""Elastic resize: resume a checkpoint on a different mesh, the
reference's ``repro/checkpoint/elastic.py``.

The store keeps unsharded logical arrays, so elasticity reduces to (a)
the new mesh's sharding rules, which drop any axis that does not divide a
dim, (b) placing each array on the new mesh (``store.restore``'s
``shardings=``: every rank keeps its own block as a DTensor) and (c)
re-planning the data shards through the MB scheduler.  A shrink from
(16, 16) to (8, 16) gates 128 chips, and the restored job continues with
re-proportioned work: the paper's "switch off the unused cores" at pod
scale.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import axis_sizes
from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.data.sharding import BatchPlan, plan_batches
from repro_torch.distributed import meshes


@dataclass
class ResizePlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    gated_chips: int
    batch_plan: Optional[BatchPlan] = None

    @property
    def is_shrink(self) -> bool:
        return int(np.prod(self.new_shape)) < int(np.prod(self.old_shape))


def plan_resize(old_mesh, new_mesh, global_batch: int, microbatch: int,
                profile: Optional[HeterogeneityProfile] = None
                ) -> ResizePlan:
    """``old_mesh`` and ``new_mesh``: ``DeviceMesh`` es or device-free
    :class:`repro_torch.core.compat.AbstractMesh` es."""
    old, new = axis_sizes(old_mesh), axis_sizes(new_mesh)
    old_n = int(np.prod(list(old.values())))
    new_n = int(np.prod(list(new.values())))
    ndp = int(np.prod([new[a] for a in meshes.batch_axes(new_mesh)]))
    prof = profile or HeterogeneityProfile.homogeneous(ndp)
    bp = plan_batches(prof, global_batch, microbatch)
    return ResizePlan(tuple(old.values()), tuple(new.values()),
                      gated_chips=max(old_n - new_n, 0), batch_plan=bp)


def restore_elastic(ckpt_dir: str, like: Any, cfg: ModelConfig, new_mesh,
                    step: Optional[int] = None):
    """Restore ``like``-shaped state re-sharded onto ``new_mesh``: every
    rank of the mesh calls it and gets DTensors holding its own blocks
    under ``meshes.param_pspecs``."""
    specs = meshes.param_pspecs(cfg, like, new_mesh)
    shardings = meshes.named(specs, new_mesh)
    return store.restore(ckpt_dir, like, step=step, shardings=shardings)

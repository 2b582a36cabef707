"""Mesh helpers on ``torch.distributed``, the reference's
``repro/core/compat.py``: the same four names, each with a
``torch.distributed`` meaning.

- :func:`make_mesh` builds a ``DeviceMesh`` over the ranks of the
  initialised default process group, one named dimension an axis.
- :func:`mesh_context` makes a mesh *ambient* for the code it wraps, as
  ``jax.set_mesh`` does; :func:`get_abstract_mesh` returns the ambient
  mesh (``None`` outside any context), and :func:`axis_size` the size of
  one of its axes.
- :class:`AbstractMesh` is a mesh's shape and axis names with no devices
  behind it (``jax.sharding.AbstractMesh``): the sharding rules
  (``distributed/meshes.py``) and ``checkpoint/elastic.plan_resize``
  accept it as well as a ``DeviceMesh``.

:func:`axis_names` and :func:`axis_sizes` read either kind of mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Sequence, Tuple

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                          default=None)


class AbstractMesh:
    """A mesh's ``shape`` (axis name -> size, in axis order) and
    ``axis_names``, with no devices and no process group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n)
                                      for a, n in zip(axis_names, shape)}

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes "
                         "to name")
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in axis order, of either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    # sizes from the layout: a sliced mesh builds its ``.mesh`` tensor on
    # demand, which a fake tensor mode would refuse
    return dict(zip(axis_names(mesh),
                    (mesh.size(i) for i in range(mesh.ndim))))


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group, whose size must be the shape's product.  Rank
    r sits at the row-major coordinate of r.  The device type follows the
    group's backend: ``cuda`` where NCCL serves CUDA tensors (``nccl``, or
    a ``cpu:gloo,cuda:nccl`` pair), ``cpu`` otherwise (gloo ranks may still
    hold CUDA tensors).  Call it on every rank; it starts no group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a process group: call torch.distributed."
            "init_process_group(backend, init_method=..., rank=r, "
            "world_size=n) on every rank first")
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def get_abstract_mesh():
    """The ambient mesh, or ``None`` outside any :func:`mesh_context`."""
    return _AMBIENT.get()


def axis_size(axis_name: str) -> int:
    """Size of ``axis_name`` on the ambient mesh."""
    mesh = get_abstract_mesh()
    if mesh is None:
        raise RuntimeError(f"axis_size({axis_name!r}) outside a "
                           "mesh_context")
    sizes = axis_sizes(mesh)
    if axis_name not in sizes:
        raise ValueError(f"the ambient mesh has axes {tuple(sizes)}, not "
                         f"{axis_name!r}")
    return sizes[axis_name]


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` ambient inside the ``with`` block: the collectives
    resolve axis names on it and the sharding hints read it."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)

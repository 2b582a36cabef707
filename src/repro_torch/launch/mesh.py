"""Production and test meshes, the reference's ``repro/launch/mesh.py``,
over :func:`repro_torch.core.compat.make_mesh`.

Each is a FUNCTION, so importing this module starts nothing: call it on
every rank of an initialised process group of the mesh's size (256 or
512 ranks for the production meshes, 8 for the test meshes; spawned gloo
ranks play the reference's forced host devices).
"""
from __future__ import annotations

from repro_torch.core.compat import make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False):
    """8-rank mini mesh for CI (same axis structure)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)

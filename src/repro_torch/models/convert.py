"""Carry parameters from the reference into the port.

The tests hand the reference's parameters over as a tree of numpy arrays
(``jax.tree.map(np.asarray, params)``); :func:`params_from_numpy` turns it
into the port's tensors with the same keys, shapes and dtypes.  bfloat16
arrives as ``ml_dtypes`` bfloat16, which torch cannot read: its bits are
moved through a 16-bit integer view, so every value arrives exactly, with
no rounding through float32.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cpu"):
    """A tree of dicts and lists of numpy arrays (or one array) → the same
    tree of tensors on ``device`` (a MoE config's ``dense_layers`` is a
    list)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _leaf(tree, device)

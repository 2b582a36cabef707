"""Gradient compression for slow links, the reference's
``repro/optim/compression.py``, with its arithmetic in its order.

Two composable transforms over trees of tensors (dicts, lists and tuples,
as ``optim/adamw.py`` walks them):

* **top-k sparsification with error feedback**: keep the k largest-|g|
  entries per tensor, carry the residual locally and add it back next step
  (Stich et al.); an all-reduce then moves k values and k indices instead
  of the dense tensor.
* **int8 linear quantization**: a per-tensor absmax scale; the quantized
  all-reduce sums int32 accumulators (8-bit values × at most 2¹⁵ ranks
  fit).

Neither is wired into ``launch/train.py``: the reference's trainer has no
compression path either.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_map


# ---------------------------------------------------------------------------
# top-k + error feedback
# ---------------------------------------------------------------------------

def topk_sparsify(g: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Zero all but the entries whose magnitude reaches the k-th largest,
    k = max(1, ⌊k_frac·n⌋) (ties at the threshold are all kept; a dense
    carrier: the sparsity is what a wire format would exploit)."""
    flat = g.reshape(-1).abs()
    k = max(1, int(flat.numel() * k_frac))
    thresh = torch.topk(flat, k, sorted=False).values.min()
    return torch.where(g.abs() >= thresh, g, 0).to(g.dtype)


def ef_compress(grads: Any, errors: Any, k_frac: float) -> Tuple[Any, Any]:
    """(grads, error carry) -> (compressed grads, new error carry): each
    leaf's float32 sum with its carry is sparsified, and what was dropped
    becomes the new carry."""
    def one(g, e):
        acc = g.to(torch.float32) + e
        comp = topk_sparsify(acc, k_frac)
        return comp.to(g.dtype), acc - comp

    pairs = tree_map(one, grads, errors)
    comp = tree_map(lambda _, p: p[0], grads, pairs)
    err = tree_map(lambda _, p: p[1], grads, pairs)
    return comp, err


def init_error_state(params) -> Any:
    """A float32 zero carry for every leaf, on the leaf's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# ---------------------------------------------------------------------------
# int8 quantized all-reduce
# ---------------------------------------------------------------------------

def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(g / scale) (half to even), clipped to ±127, as int8."""
    return torch.clamp(torch.round(g.to(torch.float32) / scale),
                       -127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 0-d scale): scale = max|g| / 127 + 1e-12."""
    scale = g.to(torch.float32).abs().max() / 127.0 + 1e-12
    return _quantize(g, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def psum_int8(g: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Quantized all-reduce over ``axis_name`` of the ambient mesh: a
    SHARED scale is agreed first (``all_reduce(MAX)`` of each rank's
    absmax, one scalar), then the int8 payloads are summed in int32 and
    dequantized once.  Error ≤ 0.5·scale a rank."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import _group

    group, _ = _group(axis_name)
    amax = g.to(torch.float32).abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s_shared = amax / 127.0 + 1e-12
    q_sum = _quantize(g, s_shared).to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    return q_sum.to(torch.float32) * s_shared


def compression_ratio(k_frac: float, bits: int = 32) -> float:
    """Wire-bytes ratio of top-k (a value and an index an entry) to dense
    float32."""
    return k_frac * (bits + 32) / 32.0

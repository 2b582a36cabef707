"""Causal GQA flash attention: the wrappers of the hand-written Hopper
kernels ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward).

Replaces the reference's ``flash_attention_pallas``
(``repro/kernels/flash_attention/kernel.py``).  The kernel reads q, k and v
in the model's [B, S, heads, hd] layout, walks the live KV tiles of each
query tile with an online softmax in float32, and skips the tiles the
causal mask or the sliding window removes entirely; the [S, S] score
matrix never reaches device memory.  On H100 the work is bound by
operations (flops at the bf16 tensor-core peak).  :func:`route` names the
kernel a call takes: ``"hopper"`` (bf16 at hd 64-256, the models' calls:
TMA into a ring of shared-memory stages, a producer thread, ``wgmma`` for
both products), ``"mma"`` (bf16 at hd 16 and 32: ``mma.sync``) or
``"f32"`` (float32: exact products on the CUDA cores).  See the source for
the design.

The forward can also write each row's log-normaliser ``lse`` [B, H, S]
(float32), which :func:`flash_attention_bwd` recomputes P from.  The
reference has no Pallas backward (it differentiates its plain attention);
the backward kernel is the gradient of this kernel's function: three
passes (D = rowsum(dO ∘ O); dK and dV a KV tile at a time; dQ a query
tile at a time), with no atomics, so repeats are bit-identical.
:func:`bwd_route` names the kernels a backward call takes: ``"hopper"``
(bf16 at hd 64-256: TMA ring, a producer warp, ``wgmma`` for every
product), ``"mma"`` (bf16 at hd 16 and 32: ``mma.sync``) or ``"f32"``
(float32: the CUDA cores).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)

HEAD_DIMS = (16, 32, 64, 128, 256)
HOPPER_HEAD_DIMS = (64, 128, 256)   # bf16 head sizes of the wgmma kernel
DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("hopper", "mma", "f32")
MAX_GRID_Y = 65_535          # blocks along b·h
BWD_LAUNCHES_PER_CALL = 3    # the backward's D, dK/dV and dQ passes

# the kernels' functions as plain tensor ops: the oracles' arithmetic
flash_attention_plain = flash_attention_ref
flash_attention_lse_plain = flash_attention_lse_ref
flash_attention_bwd_plain = flash_attention_bwd_ref


@functools.cache
def _launcher():
    lib = loader.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_launcher():
    lib = loader.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call of this type and head size launches, as
    ``flash_attention_launch`` chooses it."""
    if dtype == torch.float32:
        return "f32"
    return "hopper" if hd in HOPPER_HEAD_DIMS else "mma"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The kernels a CUDA backward call of this type and head size
    launches for its dK/dV and dQ passes, as ``flash_attention_bwd_launch``
    chooses them: the forward's table."""
    return route(dtype, hd)


def _check_inputs(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B, S, H, hd] and k, v of one [B, S, KV, "
                         f"hd] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd):
        raise ValueError(f"k and v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head size")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if not isinstance(window, int):
        raise TypeError(f"window must be a Python int, got {window!r}")


def _check_card(named):
    """The card path's preconditions on (name, tensor) pairs."""
    for name, x in named:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, return_lse: bool = False):
    """Causal attention ``[B, S, H, hd]`` of q [B, S, H, hd] over k, v
    [B, S, KV, hd], keys kept where ``kj <= qi`` and, for ``window > 0``,
    ``kj > qi - window``; with ``return_lse`` also each row's
    log-normaliser ``lse`` [B, H, S] (float32), as ``(out, lse)``.  A CUDA
    tensor goes through the kernel (contiguous, 16-byte aligned inputs), a
    CPU tensor through the plain version.  Each launch adds one to
    ``flash_attention_fwd.launches`` and to its :func:`route`'s count in
    ``.launches_by_route``.
    """
    _check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, window=window)
        if return_lse:
            return out, flash_attention_lse_plain(q, k, window=window)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} blocks exceed the grid's "
                         f"{MAX_GRID_Y}")
    _check_card((("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 B, S, H, KV, hd, max(window, 0), 1.0 / math.sqrt(hd),
                 int(q.dtype == torch.bfloat16), stream)
    loader.check(lib, err, "flash_attention launch")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route(q.dtype, hd)] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_fwd`'s function at (q, k, v),
    given its output ``out``, its ``lse`` [B, H, S] (float32) and the
    output's gradient ``dout``: each in its input's shape and type.  A CUDA
    tensor goes through the backward kernel (one call: three launches on
    the stream, D, then dK and dV, then dQ), a CPU tensor through the plain
    version.  Each CUDA call adds its ``BWD_LAUNCHES_PER_CALL`` launches to
    ``flash_attention_bwd.launches`` and to its :func:`bwd_route`'s count
    in ``.launches_by_route``.
    """
    _check_inputs(q, k, v, window)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} on "
                             f"{x.device} is not q's {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if (tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} is not "
                         f"float32 [B, H, S] = {(B, H, S)} on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention_bwd kernel for {q.device}")
    if max(B * H, B * KV) > MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} blocks exceed the grid's "
                         f"{MAX_GRID_Y}")
    _check_card((("q", q), ("k", k), ("v", v), ("out", out), ("lse", lse),
                 ("dout", dout)))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    d = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib, fn = _bwd_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), d.data_ptr(),
                 B, S, H, KV, hd, max(window, 0), 1.0 / math.sqrt(hd),
                 int(q.dtype == torch.bfloat16), stream)
    loader.check(lib, err, "flash_attention_bwd launch")
    flash_attention_bwd.launches += BWD_LAUNCHES_PER_CALL
    flash_attention_bwd.launches_by_route[bwd_route(q.dtype, hd)] += \
        BWD_LAUNCHES_PER_CALL
    return dq, dk, dv


def zero_launches() -> None:
    """Set the forward's and the backward's totals and every route's
    count of launches to 0."""
    for fn in (flash_attention_fwd, flash_attention_bwd):
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)


zero_launches()

"""Causal GQA flash attention (forward): the wrapper of the hand-written
Hopper kernel ``csrc/flash_attention.cu``.

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
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
HOPPER_HEAD_DIMS = (64, 128, 256)   # bf16 head sizes of the wgmma kernel
DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("hopper", "mma", "f32")
MAX_GRID_Y = 65_535          # blocks along b·h

# the kernel's function as plain tensor ops: the oracle's arithmetic
flash_attention_plain = flash_attention_ref


@functools.cache
def _launcher():
    lib = loader.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call of this type and head size launches, as
    ``flash_attention_launch`` chooses it."""
    if dtype == torch.float32:
        return "f32"
    return "hopper" if hd in HOPPER_HEAD_DIMS else "mma"


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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0) -> torch.Tensor:
    """Causal attention ``[B, S, H, hd]`` of q [B, S, H, hd] over k, v
    [B, S, KV, hd], keys kept where ``kj <= qi`` and, for ``window > 0``,
    ``kj > qi - window``.  A CUDA tensor goes through the kernel
    (contiguous, 16-byte aligned inputs), a CPU tensor through the plain
    version.  Each launch adds one to ``flash_attention_fwd.launches`` and
    to its :func:`route`'s count in ``.launches_by_route``.
    """
    _check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} blocks exceed the grid's "
                         f"{MAX_GRID_Y}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KV, hd, max(window, 0), 1.0 / math.sqrt(hd),
                 int(q.dtype == torch.bfloat16), stream)
    loader.check(lib, err, "flash_attention launch")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route(q.dtype, hd)] += 1
    return out


def zero_launches() -> None:
    """Set the total and every route's count of launches to 0."""
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


zero_launches()

"""RWKV-6 WKV recurrence (forward): the wrapper of the hand-written Hopper
kernel ``csrc/wkv6.cu``.

Replaces the reference's ``wkv6_pallas``
(``repro/kernels/rwkv6_wkv/kernel.py:87``).  Column m of the [n, n] state,
``S[:, m]``, evolves on its own: its update needs ``r_t``, ``k_t`` and
``w_t`` (indexed by the row i), ``u`` and the one value ``v_t[m]``.  So
the kernel gives each (b, h) one block that keeps S in registers for the
whole of T, each thread a tile of 8 rows × 4 columns (n²/32 threads), so
that each value of r, k and w read from shared memory serves 4 columns.
One thread loads 16 steps of r, k, v and w at a time by TMA into a ring
of 3 stages; the row groups' partial sums of y meet in shared memory once
a stage, and the u term, ``v_t[m]·Σ_i r_t[i]·u[i]·k_t[i]``, is summed
once a step for the block.  On H100 the function is bound by bytes
(5·n·4 a step and head, against 5·n² + 5·n float32 operations): 0.203 ms
at rwkv6-7b's prefill shape, where the kernel takes 0.396–0.398 ms
(chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W).  See the source for the
design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

HEAD_SIZES = (8, 16, 32, 64)      # n, the kernel's template sizes


@functools.cache
def _launcher():
    lib = loader.load("wkv6")
    fn = lib.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(r, k, v, w, u, s0):
    if r.dim() != 4:
        raise ValueError(f"want r of shape [B, T, H, n], got "
                         f"{tuple(r.shape)}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} is not r's "
                             f"{tuple(r.shape)}")
    B, T, H, n = r.shape
    if tuple(u.shape) != (H, n):
        raise ValueError(f"u {tuple(u.shape)} is not [H, n] = {(H, n)}")
    if tuple(s0.shape) != (B, H, n, n):
        raise ValueError(f"s0 {tuple(s0.shape)} is not [B, H, n, n] = "
                         f"{(B, H, n, n)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} is not one of the kernel's "
                         f"{HEAD_SIZES}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """(y [B, T, H, n], S_final [B, H, n, n]) of the recurrence
    ``y_t = r_t·(S_{t-1} + diag(u)·k_tᵀv_t)``, ``S_t = diag(w_t)·S_{t-1} +
    k_tᵀv_t`` from ``s0``, all float32.  A CUDA tensor goes through the
    kernel (contiguous inputs; all but u 16-byte aligned), a CPU tensor
    through the plain version.
    """
    _check_inputs(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for {r.device}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "u" and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "reads it by TMA or as float4)")
    B, T, H, n = r.shape
    y = torch.empty((B, T, H, n), dtype=torch.float32, device=r.device)
    s_final = torch.empty((B, H, n, n), dtype=torch.float32,
                          device=r.device)
    if s0.numel() == 0:
        return y, s_final
    lib, fn = _launcher()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                 s_final.data_ptr(), B, T, H, n, stream)
    loader.check(lib, err, "wkv6 launch")
    wkv6_fwd.launches += 1
    return y, s_final


wkv6_fwd.launches = 0

"""Selective scan (forward): the wrapper of the hand-written Hopper kernel
``csrc/selective_scan.cu``.

Replaces the reference's ``selective_scan_pallas``
(``repro/kernels/selective_scan/kernel.py``).  The recurrence
``h_t = a_t ⊙ h_{t-1} + b_t`` has B·D·N independent lanes; the kernel
gives each lane one thread that holds ``h`` in a register and walks T in
order, and the N lanes of one channel meet in warp shuffles for
``y_t = C_t · h_t``.  On H100 it is bound by bytes: a and b are read once,
2·B·T·D·N·4 bytes for four flops per element.  See the source for the
design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N must divide a warp's 32 lanes
MAX_GRID_Y = 65_535                    # blocks along the batch

# the kernel's function as plain tensor ops: the oracle's arithmetic
selective_scan_plain = selective_scan_ref


@functools.cache
def _launcher():
    lib = loader.load("selective_scan")
    fn = lib.selective_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(a, b, C, h0):
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"want a and b of one [B, T, D, N] shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, T, D, N = a.shape
    if tuple(C.shape) != (B, T, N):
        raise ValueError(f"C {tuple(C.shape)} is not [B, T, N] = "
                         f"{(B, T, N)}")
    if tuple(h0.shape) != (B, D, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not [B, D, N] = "
                         f"{(B, D, N)}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} does not divide 32 "
                         f"{STATE_SIZES}")
    for name, x in (("a", a), ("b", b), ("C", C), ("h0", h0)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")


def selective_scan_fwd(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                       h0: torch.Tensor):
    """(y [B, T, D], h_last [B, D, N]) of the scan ``h_t = a_t ⊙ h_{t-1} +
    b_t``, ``y_t = Σ_n C_t[n]·h_t[:, n]`` from ``h0``, all float32.  A CUDA
    tensor goes through the kernel (contiguous inputs), a CPU tensor
    through the plain version.
    """
    _check_inputs(a, b, C, h0)
    if a.device.type == "cpu":
        return selective_scan_plain(a, b, C, h0)
    if a.device.type != "cuda":
        raise ValueError(f"no selective_scan kernel for {a.device}")
    B, T, D, N = a.shape
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_GRID_Y}")
    if D * N >= 2**31:
        # the kernel's lane index within a batch row is a 32-bit int
        raise ValueError(f"D*N = {D * N} lanes exceed a 32-bit index")
    for name, x in (("a", a), ("b", b), ("C", C), ("h0", h0)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=a.device)
    if h0.numel() == 0:
        return y, h_last
    lib, fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), C.data_ptr(), h0.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), B, T, D, N, stream)
    loader.check(lib, err, "selective_scan launch")
    selective_scan_fwd.launches += 1
    return y, h_last


selective_scan_fwd.launches = 0

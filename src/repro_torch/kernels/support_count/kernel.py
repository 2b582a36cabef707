"""Int8 tensor-core support counting: the pipeline's ``mxu`` variant.

Replaces the reference's ``support_count_pallas``
(``repro/kernels/support_count/kernel.py``), which runs the containment test
as an int8 matmul on the TPU's matrix unit:

  count[m] = Σ_t [ Σ_i T[t, i]·C[m, i] == sizes[m] ]

On H100 the work is 2·N·M·I int8 operations against 1,979 dense TOP/s, and
the bytes are one read of T and C; at the pipeline's shapes (a few thousand
rows and candidates, ~1k items) that makes it operation-bound.  The kernel
issues ``mma.sync`` m16n8k32 s8×s8→s32 on the tensor cores (exact integer
accumulation), with the ``== sizes`` compare and the sum over transactions
in the epilogue, so the [N, M] dot matrix is never written.  A block owns
64 transactions × 128 candidates, stages 64-item slices of both in padded
shared memory (bank-conflict-free fragment loads), and ``atomicAdd``s its
per-candidate hit counts; integer atomics commute, so the result is exact.
It uses no TMA or ``wgmma`` yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader

# the kernel stages the item axis 64 bytes at a time with 16-byte loads
ITEM_MULTIPLE = 64


def support_count_int8_plain(T: torch.Tensor, C: torch.Tensor,
                             sizes: torch.Tensor) -> torch.Tensor:
    """The kernel's function as plain tensor ops: [N, I], [M, I] int8 and
    [M] int32 sizes -> [M] int32 counts.  The dot is float32 (CUDA matmul
    takes no integer operands), exact because every sum is an integer
    below 2**24."""
    if T.shape[1] >= 1 << 24:
        raise ValueError(f"{T.shape[1]} items: float32 dots are exact only "
                         "below 2**24")
    dots = T.to(torch.float32) @ C.to(torch.float32).T
    return (dots == sizes.to(torch.float32)[None, :]).sum(
        dim=0, dtype=torch.int32)


@functools.cache
def _launcher():
    lib = loader.load("support_count_int8")
    fn = lib.support_count_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(T, C, sizes):
    if T.dim() != 2 or C.dim() != 2 or T.shape[1] != C.shape[1]:
        raise ValueError(f"want T [N, I] and C [M, I], got "
                         f"{tuple(T.shape)} and {tuple(C.shape)}")
    if sizes.shape != (C.shape[0],):
        raise ValueError(f"sizes must be [{C.shape[0]}], "
                         f"got {tuple(sizes.shape)}")
    for name, x, dtype in (("T", T, torch.int8), ("C", C, torch.int8),
                           ("sizes", sizes, torch.int32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != T.device:
            raise ValueError(f"{name} is on {x.device}, T on {T.device}")


def support_count_int8(T: torch.Tensor, C: torch.Tensor,
                       sizes: torch.Tensor) -> torch.Tensor:
    """Int8-dot support counts, ``[M]`` int32.

    T: [N, I] and C: [M, I] int8 0/1, sizes: [M] int32.  A CUDA tensor
    goes through the kernel (``I % 64 == 0``, contiguous, 16-byte
    aligned); a CPU tensor through the plain version.
    """
    _check_inputs(T, C, sizes)
    if T.device.type == "cpu":
        return support_count_int8_plain(T, C, sizes)
    if T.device.type != "cuda":
        raise ValueError(f"no support_count_int8 kernel for {T.device}")
    N, I = T.shape
    M = C.shape[0]
    if I % ITEM_MULTIPLE:
        raise ValueError(f"the kernel stages {ITEM_MULTIPLE} items at a "
                         f"time: I={I}")
    for name, x in (("T", T), ("C", C), ("sizes", sizes)):
        if not x.is_contiguous() or (x is not sizes and x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous"
                             + ("" if x is sizes else " and 16-byte aligned"))
    out = torch.zeros(M, dtype=torch.int32, device=T.device)
    if N == 0 or M == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(T.data_ptr(), C.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), N, M, I, stream)
    loader.check(lib, err, "support_count_int8 launch")
    support_count_int8.launches += 1
    return out


support_count_int8.launches = 0

"""Int8 tensor-core rule matching: serving's ``mxu`` variant.

Replaces the reference's ``rule_scores_pallas``
(``repro/kernels/rule_match/kernel.py``), which runs the antecedent
containment test as an int8 matmul on the TPU's matrix unit:

  score[b, r] = [ Σ_i Q[b, i]·A[r, i] == sizes[r] ] · conf[r]

At the serving shapes (a batch of 8 or 64 queries against the whole
index) the bytes bound it on H100: one read of the [R, I] antecedents and
one write of the [B, R] float scores outweigh 2·B·R·I int8 operations at
1,979 dense TOP/s.  The kernel issues ``mma.sync`` m16n8k32 s8×s8→s32 on
the tensor cores (exact integer accumulation), with the ``== sizes``
compare and the ``conf`` weight in the epilogue, so no integer [B, R]
matrix is written.  A block owns 16 queries × 64 rules and stages 64-item
slices of both in padded shared memory; serving pads B to 8, so the rows of
the 16-row fragment past B are zeros that are never stored.  It uses no
TMA or ``wgmma`` yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.rule_match.ref import rule_scores_ref
from repro_torch.kernels.support_count.ref import MAX_EXACT_ITEMS

# the kernel stages the item axis 64 bytes at a time with 16-byte loads
ITEM_MULTIPLE = 64


def rule_scores_int8_plain(Q: torch.Tensor, A: torch.Tensor,
                           sizes: torch.Tensor,
                           conf: torch.Tensor) -> torch.Tensor:
    """The kernel's function as plain tensor ops: [B, I], [R, I] int8,
    [R] float32 sizes and conf -> [B, R] float32 (the oracle's float32
    dot, exact below 2**24 items)."""
    return rule_scores_ref(Q, A, sizes, conf)


@functools.cache
def _launcher():
    lib = loader.load("rule_match_int8")
    fn = lib.rule_match_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(Q, A, sizes, conf):
    if Q.dim() != 2 or A.dim() != 2 or Q.shape[1] != A.shape[1]:
        raise ValueError(f"want Q [B, I] and A [R, I], got "
                         f"{tuple(Q.shape)} and {tuple(A.shape)}")
    for name, x in (("sizes", sizes), ("conf", conf)):
        if x.shape != (A.shape[0],):
            raise ValueError(f"{name} must be [{A.shape[0]}], "
                             f"got {tuple(x.shape)}")
    for name, x, dtype in (("Q", Q, torch.int8), ("A", A, torch.int8),
                           ("sizes", sizes, torch.float32),
                           ("conf", conf, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != Q.device:
            raise ValueError(f"{name} is on {x.device}, Q on {Q.device}")


def rule_scores_int8(Q: torch.Tensor, A: torch.Tensor, sizes: torch.Tensor,
                     conf: torch.Tensor) -> torch.Tensor:
    """Int8-dot rule scores, ``[B, R]`` float32.

    Q: [B, I] and A: [R, I] int8 0/1, sizes: [R] float32 (-1 on padded
    rows), conf: [R] float32.  A CUDA tensor goes through the kernel
    (``I % 64 == 0``, contiguous, 16-byte aligned); a CPU tensor through
    the plain version.
    """
    _check_inputs(Q, A, sizes, conf)
    if Q.device.type == "cpu":
        return rule_scores_int8_plain(Q, A, sizes, conf)
    if Q.device.type != "cuda":
        raise ValueError(f"no rule_match_int8 kernel for {Q.device}")
    B, I = Q.shape
    R = A.shape[0]
    if I % ITEM_MULTIPLE:
        raise ValueError(f"the kernel stages {ITEM_MULTIPLE} items at a "
                         f"time: I={I}")
    if I >= MAX_EXACT_ITEMS:
        raise ValueError(f"{I} items: the float32 compare is exact only "
                         f"below {MAX_EXACT_ITEMS}")
    for name, x in (("Q", Q), ("A", A), ("sizes", sizes), ("conf", conf)):
        if not x.is_contiguous() or (x.dim() == 2 and x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous"
                             + (" and 16-byte aligned" if x.dim() == 2
                                else ""))
    out = torch.empty((B, R), dtype=torch.float32, device=Q.device)
    if B == 0 or R == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(Q.data_ptr(), A.data_ptr(), sizes.data_ptr(),
                 conf.data_ptr(), out.data_ptr(), B, R, I, stream)
    loader.check(lib, err, "rule_match_int8 launch")
    rule_scores_int8.launches += 1
    return out


rule_scores_int8.launches = 0

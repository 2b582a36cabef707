"""Packed-popcount rule matching: the kernel serving runs by default.

Replaces the reference's ``rule_scores_fused_pallas``
(``repro/kernels/rule_match/fused.py``).  Items are packed 32 to a word
(``pack_words``, shared with the support-count kernel) and

  score[b, r] = [ Σ_w popc(Qw[b, w] & Aw[r, w]) == sizes[r] ] · conf[r]

is computed in one launch: the subset test, the ``== sizes`` filter and the
confidence weight never leave the chip as an unweighted match matrix.

Serving keeps the whole [B, R] score matrix (mining reduces over
transactions instead), so the CUDA kernel is output-stationary: a block
owns 64 rules, one per thread with its words in registers, and 8 queries
whose words sit in shared memory (every thread reads the same word, a
broadcast); each thread writes its own rule's column, so the stores
coalesce and no atomics are needed.  At the serving shapes the popcounts,
not the bytes, bound it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.support_count.fused import pack_words, popcount32

# bytes of int64 temporaries per chunk of the plain version: the [B, R, W]
# intermediate of a wide index would be gigabytes, so it walks R in slices
_PLAIN_CHUNK_BYTES = 1 << 28


def rule_scores_packed_plain(Qw: torch.Tensor, Aw: torch.Tensor,
                             sizes: torch.Tensor,
                             conf: torch.Tensor) -> torch.Tensor:
    """The kernel's function as plain tensor ops: [B, W], [R, W] int32
    words, [R] int32 sizes and [R] float32 conf -> [B, R] float32."""
    B, W = Qw.shape
    R = Aw.shape[0]
    q = Qw.to(torch.int64) & 0xFFFFFFFF
    a = Aw.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((B, R), dtype=torch.float32, device=Qw.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, B * W * 8))
    for r0 in range(0, R, step):
        dots = popcount32(q[:, None, :] & a[None, r0:r0 + step, :]).sum(2)
        match = dots == sizes[None, r0:r0 + step]
        out[:, r0:r0 + step] = (match.to(torch.float32)
                                * conf[None, r0:r0 + step])
    return out


@functools.cache
def _launcher():
    lib = loader.load("rule_match_packed")
    fn = lib.rule_match_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(Qw, Aw, sizes, conf):
    if Qw.dim() != 2 or Aw.dim() != 2 or Qw.shape[1] != Aw.shape[1]:
        raise ValueError(f"want Qw [B, W] and Aw [R, W], got "
                         f"{tuple(Qw.shape)} and {tuple(Aw.shape)}")
    for name, x in (("sizes", sizes), ("conf", conf)):
        if x.shape != (Aw.shape[0],):
            raise ValueError(f"{name} must be [{Aw.shape[0]}], "
                             f"got {tuple(x.shape)}")
    for name, x, dtype in (("Qw", Qw, torch.int32), ("Aw", Aw, torch.int32),
                           ("sizes", sizes, torch.int32),
                           ("conf", conf, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != Qw.device:
            raise ValueError(f"{name} is on {x.device}, Qw on {Qw.device}")


def rule_scores_packed(Qw: torch.Tensor, Aw: torch.Tensor,
                       sizes: torch.Tensor,
                       conf: torch.Tensor) -> torch.Tensor:
    """Packed-popcount rule scores, ``[B, R]`` float32.

    Qw: [B, W] and Aw: [R, W] packed words (int32 bit patterns), sizes:
    [R] int32 (-1 on padded rows), conf: [R] float32.  A CUDA tensor goes
    through the kernel (``W % 4 == 0``, contiguous, 16-byte aligned); a
    CPU tensor through the plain version.
    """
    _check_inputs(Qw, Aw, sizes, conf)
    if Qw.device.type == "cpu":
        return rule_scores_packed_plain(Qw, Aw, sizes, conf)
    if Qw.device.type != "cuda":
        raise ValueError(f"no rule_match_packed kernel for {Qw.device}")
    B, W = Qw.shape
    R = Aw.shape[0]
    if W % 4:
        raise ValueError(f"the kernel reads 4 words at a time: W={W}")
    for name, x in (("Qw", Qw), ("Aw", Aw), ("sizes", sizes), ("conf", conf)):
        if not x.is_contiguous() or (x.dim() == 2 and x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous"
                             + (" and 16-byte aligned" if x.dim() == 2
                                else ""))
    out = torch.empty((B, R), dtype=torch.float32, device=Qw.device)
    if B == 0 or R == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(Qw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(Qw.data_ptr(), Aw.data_ptr(), sizes.data_ptr(),
                 conf.data_ptr(), out.data_ptr(), B, R, W, stream)
    loader.check(lib, err, "rule_match_packed launch")
    rule_scores_packed.launches += 1
    return out


rule_scores_packed.launches = 0


def rule_scores_fused(Q: torch.Tensor, A: torch.Tensor, sizes: torch.Tensor,
                      conf: torch.Tensor) -> torch.Tensor:
    """Unpacked 0/1 bitmaps in, scores out: Q [B, I] and A [R, I] (item
    axes 32-aligned), sizes/conf [R] float32 per the index padding
    contract.  Packs the words and casts sizes to int32 (the -1 of a
    padded row survives the cast)."""
    return rule_scores_packed(pack_words(Q), pack_words(A),
                              sizes.to(torch.int32), conf.to(torch.float32))

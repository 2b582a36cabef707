"""Packed-popcount support counting: the kernel the pipeline runs by default.

Replaces the reference's ``support_count_fused_pallas``
(``repro/kernels/support_count/fused.py``).  Items are packed 32 to a word
(``pack_words``, plain tensor ops outside the kernel) and

  count[m] = #{ t : Σ_w popc(Tw[t, w] & Cw[m, w]) == sizes[m] }

is computed in one launch: containment test, ``== sizes`` filter and the
count over transactions never leave the chip as an [N, M] matrix.

On H100 the kernel is bound by operations, not bytes: N·M·W AND+popcount+add
triples against 16 popcounts per clock per SM, while it reads each word of
Tw and Cw once.  The design keeps the popcount units fed: one thread owns
one candidate and holds 32 of its words in registers, a block of 128
candidates stages 32 transaction rows × 32 words in shared memory (every
thread reads the same word, a broadcast), so each 16-byte shared load feeds
four popcounts and each candidate word loaded feeds 32.  Blocks run in no
order, so instead of revisiting an output block as the TPU grid does, a
block owns a candidate slice and a chunk of transactions and ``atomicAdd``s
its int32 partial counts; integer atomics commute, so the result is exact.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader

WORD_BITS = 32
# bytes of int64 temporaries per chunk of the plain version: the [N, M, W]
# intermediate at full width would be gigabytes, so it walks M in slices
_PLAIN_CHUNK_BYTES = 1 << 28


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """0/1 bitmap [R, I] (I % 32 == 0) -> packed words [R, I/32] int32.

    Bit b of word w holds item ``w * 32 + b``; the words are uint32 bit
    patterns held in int32 (torch has no general uint32 arithmetic).
    """
    r, i = x.shape
    if i % WORD_BITS:
        raise ValueError(f"item axis must be 32-aligned, got {i}")
    bits = x.reshape(r, i // WORD_BITS, WORD_BITS).to(torch.int64)
    weights = 1 << torch.arange(WORD_BITS, dtype=torch.int64, device=x.device)
    words = (bits * weights).sum(dim=2)                  # [0, 2**32)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2**32) (SWAR; torch has no
    popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def support_count_packed_plain(Tw: torch.Tensor, Cw: torch.Tensor,
                               sizes: torch.Tensor) -> torch.Tensor:
    """The kernel's function as plain tensor ops: [N, W], [M, W] int32
    words and [M] int32 sizes -> [M] int32 counts."""
    N, W = Tw.shape
    M = Cw.shape[0]
    t = Tw.to(torch.int64) & 0xFFFFFFFF
    c = Cw.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty(M, dtype=torch.int32, device=Tw.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, N * W * 8))
    for m0 in range(0, M, step):
        dots = popcount32(t[:, None, :] & c[None, m0:m0 + step, :]).sum(2)
        out[m0:m0 + step] = (dots == sizes[None, m0:m0 + step]).sum(
            dim=0, dtype=torch.int32)
    return out


@functools.cache
def _launcher():
    lib = loader.load("support_count_packed")
    fn = lib.support_count_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(Tw, Cw, sizes):
    if Tw.dim() != 2 or Cw.dim() != 2 or Tw.shape[1] != Cw.shape[1]:
        raise ValueError(f"want Tw [N, W] and Cw [M, W], got "
                         f"{tuple(Tw.shape)} and {tuple(Cw.shape)}")
    if sizes.shape != (Cw.shape[0],):
        raise ValueError(f"sizes must be [{Cw.shape[0]}], "
                         f"got {tuple(sizes.shape)}")
    for name, x in (("Tw", Tw), ("Cw", Cw), ("sizes", sizes)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != Tw.device:
            raise ValueError(f"{name} is on {x.device}, Tw on {Tw.device}")


def support_count_packed(Tw: torch.Tensor, Cw: torch.Tensor,
                         sizes: torch.Tensor) -> torch.Tensor:
    """Packed-popcount support counts, ``[M]`` int32.

    Tw: [N, W] and Cw: [M, W] packed words (int32 bit patterns), sizes:
    [M] int32.  A CUDA tensor goes through the kernel (``W % 4 == 0``,
    contiguous, 16-byte aligned); a CPU tensor through the plain version.
    """
    _check_inputs(Tw, Cw, sizes)
    if Tw.device.type == "cpu":
        return support_count_packed_plain(Tw, Cw, sizes)
    if Tw.device.type != "cuda":
        raise ValueError(f"no support_count_packed kernel for {Tw.device}")
    N, W = Tw.shape
    M = Cw.shape[0]
    if W % 4:
        raise ValueError(f"the kernel reads 4 words at a time: W={W}")
    for name, x in (("Tw", Tw), ("Cw", Cw), ("sizes", sizes)):
        if not x.is_contiguous() or (x is not sizes and x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous"
                             + ("" if x is sizes else " and 16-byte aligned"))
    out = torch.zeros(M, dtype=torch.int32, device=Tw.device)
    if N == 0 or M == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(Tw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(Tw.data_ptr(), Cw.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), N, M, W, stream)
    loader.check(lib, err, "support_count_packed launch")
    support_count_packed.launches += 1
    return out


support_count_packed.launches = 0

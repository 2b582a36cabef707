"""Packed-popcount support counting: the kernel the pipeline runs by default.

Replaces the reference's ``support_count_fused_pallas``
(``repro/kernels/support_count/fused.py:94``).  Items are packed 32 to a
word (``pack_words``, plain tensor ops outside the kernel) and

  count[m] = #{ t : Σ_w popc(Tw[t, w] & Cw[m, w]) == sizes[m] }

is computed in one launch: containment test, ``== sizes`` filter and the
count over transactions never leave the chip as an [N, M] matrix.

On H100 a mining round gives it one transaction tile [3,128 × 32 words]
against the round's candidates (M = 2,176 at k = 2, then 256, 128, 128).
Its bit AND-popcount-adds take under a microsecond on Hopper's binary
tensor cores and its bytes less, so the launch, one trip to memory and
the epilogue set its time.  The CUDA kernel (``csrc/support_count_packed.cu``)
runs ``wgmma`` m64nNk256 ``.b1 .and.popc``: a k256 step reads 32 bytes
of a row as an int8 k32 step does, so it is the int8 support-count kernel
(``csrc/support_count_wgmma.cuh``: transactions on M against candidates
on N, TMA from a producer warp through a ring of ``mbarrier`` stages, the
``== sizes`` compare and the sum over transactions in registers, one
``atomicAdd`` a candidate a CTA) with the b1 instruction over rows of 4·W
bytes, on tiles of 64 transactions by 64 candidates.  :func:`geometry`
picks how many transaction tiles a CTA walks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import loader, sm_count
from repro_torch.kernels.support_count import kernel as int8_kernel

WORD_BITS = 32
# the wrapper's contract on the word axis: TMA rows of a multiple of 16
# bytes
WORD_MULTIPLE = 4
# CTAs an SM that geometry() aims a launch at: six fit (registers), and
# four walking four tiles each beat one wave of single tiles at k = 2
CTAS_PER_SM = 4
# transaction tiles a CTA walks at most: its hit counters hold 16 bits, 16
# hits a tile (the launcher refuses 4,096)
MAX_TILES = 2048
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


class Geometry(NamedTuple):
    """A launch of the kernel, whose CTAs each take tiles of 64
    transactions (one consumer warpgroup, wgmma's M) by 64 candidates
    (wgmma's N): the transaction tiles a CTA walks."""
    tiles: int

    def stages(self, N: int, W: int) -> int:
        """The slabs in flight, as the launcher sets them: two where a CTA
        reads more than one, else one."""
        t_tiles = -(-N // 64)
        grid_y = min(-(-t_tiles // self.tiles), int8_kernel.MAX_GRID_Y)
        return min(2, -(-4 * W // int8_kernel.SLAB) * -(-t_tiles // grid_y))

    def describe(self, N: int, M: int, W: int) -> str:
        ctas = -(-(-(-N // 64)) // self.tiles) * -(-M // 64)
        return (f"tiles of 64 transactions x 64 candidates, {self.tiles} a "
                f"CTA = {ctas} CTAs of 160 threads, "
                f"{self.stages(N, W)} stages")


def geometry(N: int, M: int, W: int,
             sms: int = int8_kernel.H100_SMS) -> Geometry:
    """The launch geometry for [N, W] transaction words against [M, W]
    candidate words.

    Tiles of 64 transactions (one warpgroup) by 64 candidates: the
    fastest tile at each of the dense mine's rounds
    (``tools/support_count_packed_designs.py``), where wider tiles ran
    slower epilogues on fewer CTAs an SM.  A CTA walks ``tiles``
    transaction tiles, doubling (up to MAX_TILES) while the CTAs would
    number more than CTAS_PER_SM an SM, through a ring of two stages, so
    that one wave of CTAs streams the next tile's slabs while the tensor
    cores run the last.
    """
    t_tiles, c_tiles = -(-N // 64), -(-M // 64)
    tiles = 1
    while tiles < min(t_tiles, MAX_TILES) and \
            -(-t_tiles // tiles) * c_tiles > CTAS_PER_SM * sms:
        tiles *= 2
    return Geometry(tiles)


@functools.cache
def _launcher():
    lib = loader.load("support_count_packed")
    fn = lib.support_count_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
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
    contiguous, 16-byte aligned) at :func:`geometry`'s launch geometry; a
    CPU tensor through the plain version.
    """
    _check_inputs(Tw, Cw, sizes)
    if Tw.device.type == "cpu":
        return support_count_packed_plain(Tw, Cw, sizes)
    if Tw.device.type != "cuda":
        raise ValueError(f"no support_count_packed kernel for {Tw.device}")
    N, W = Tw.shape
    M = Cw.shape[0]
    if W % WORD_MULTIPLE:
        raise ValueError(f"the kernel takes the word axis in multiples of "
                         f"{WORD_MULTIPLE}: W={W}")
    for name, x in (("Tw", Tw), ("Cw", Cw), ("sizes", sizes)):
        if not x.is_contiguous() or (x is not sizes and x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous"
                             + ("" if x is sizes else " and 16-byte aligned"))
    out = torch.zeros(M, dtype=torch.int32, device=Tw.device)
    if N == 0 or M == 0:
        return out
    geom = geometry(N, M, W, sm_count(Tw.device.index or 0))
    lib, fn = _launcher()
    with torch.cuda.device(Tw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(Tw.data_ptr(), Cw.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), N, M, W, geom.tiles, stream)
    loader.check(lib, err, "support_count_packed launch")
    support_count_packed.launches += 1
    return out


support_count_packed.launches = 0

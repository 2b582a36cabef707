"""Int8 tensor-core support counting: the pipeline's ``mxu`` variant.

Replaces the reference's ``support_count_pallas``
(``repro/kernels/support_count/kernel.py:65``, its ``pallas_call`` at
``:74``), which runs the containment test as an int8 matmul on the TPU's
matrix unit:

  count[m] = Σ_t [ Σ_i T[t, i]·C[m, i] == sizes[m] ]

On H100 a mining round gives it one transaction tile [3,128 × 1,024]
against the round's candidates (M = 2,176 at k = 2, then 256, 128, 128).
At k = 2 the 2·N·M·I int8 operations bound it (7.0 µs at 1,979 dense
TOP/s); at M = 128 the bytes of T do (about 1 µs), and the launch, one
trip to memory and filling the card's 132 SMs are what count.  The CUDA
kernel (``csrc/support_count_int8.cu``) runs ``wgmma`` m64nNk32 s8 with
the transactions on M and a tile of 64, 128 or 256 candidates on N, fed
by TMA from a producer warp through a ring of ``mbarrier`` stages; the
``== sizes`` compare and the sum over transactions happen in registers,
with one ``atomicAdd`` a candidate a CTA (exact).  A small round takes
narrower candidate tiles, so that its CTAs fill half the card.
:func:`geometry` picks the tile, the warpgroups and the ring for each
shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import loader, sm_count

# the wrapper's contract on the item axis (the kernel's TMA loads need
# rows of a multiple of 16 bytes and zero-fill a ragged last slab)
ITEM_MULTIPLE = 64
SLAB = 128                     # items a TMA box and a swizzled row hold
TILE_WIDTHS = (64, 128, 256)   # wgmma N: candidates a tile
MAX_STAGES = 8                 # slabs in flight in a CTA's ring
MAX_GRID_Y = 65535             # transaction tiles a launch spreads over
SMEM_LIMIT = 232448            # dynamic shared memory a CTA may use
H100_SMS = 132


class Geometry(NamedTuple):
    """A launch of the kernel: consumer warpgroups a CTA (64 transactions
    each, wgmma's M), candidates a tile (wgmma's N), and the slabs a CTA
    keeps in flight."""
    warpgroups: int
    n: int
    stages: int

    def smem_bytes(self) -> int:
        """The CTA's shared memory, as the kernel lays it out: the ring,
        two barriers a stage, and the tile's sizes and hits."""
        ring = self.stages * (64 * self.warpgroups + self.n) * SLAB
        return 1024 + ring + 16 * self.stages + 8 * self.n

    def describe(self, N: int, M: int, I: int) -> str:
        rows = 64 * self.warpgroups
        tiles = -(-N // rows) * -(-M // self.n)
        return (f"tiles of {rows} transactions x {self.n} candidates "
                f"= {tiles} CTAs of {128 * self.warpgroups + 32} threads, "
                f"{self.stages} stages")


def max_stages(warpgroups: int, n: int) -> int:
    """The most stages whose ring fits in a CTA's shared memory."""
    return max(s for s in range(1, MAX_STAGES + 1)
               if Geometry(warpgroups, n, s).smem_bytes() <= SMEM_LIMIT)


def geometry(N: int, M: int, I: int, sms: int = H100_SMS) -> Geometry:
    """The launch geometry for [N, I] transactions against [M, I]
    candidates.

    N (candidates a tile) is the smallest of 64, 128 and 256 that covers
    M, or 256, halved (down to 64) while the tiles of 64 transactions
    would fill less than half a wave of ``sms`` CTAs: more CTAs each
    re-reading its transactions beat fewer that read more candidates
    (``tools/support_count_int8_designs.py``).  A CTA takes 128
    transactions (two warpgroups) once tiles of 64 would overfill a wave.
    The ring holds every slab a CTA reads, up to 8 and what shared memory
    allows.
    """
    n = next(w for w in TILE_WIDTHS if w >= min(M, TILE_WIDTHS[-1]))
    while n > TILE_WIDTHS[0] and 2 * -(-N // 64) * -(-M // n) <= sms:
        n //= 2
    warpgroups = 2 if -(-N // 64) * -(-M // n) > sms else 1
    t_tiles = -(-N // (64 * warpgroups))
    per_cta = -(-I // SLAB) * -(-t_tiles // min(t_tiles, MAX_GRID_Y))
    stages = max(1, min(per_cta, max_stages(warpgroups, n)))
    return Geometry(warpgroups, n, stages)


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
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
    aligned) at :func:`geometry`'s launch geometry; a CPU tensor through
    the plain version.
    """
    _check_inputs(T, C, sizes)
    if T.device.type == "cpu":
        return support_count_int8_plain(T, C, sizes)
    if T.device.type != "cuda":
        raise ValueError(f"no support_count_int8 kernel for {T.device}")
    N, I = T.shape
    M = C.shape[0]
    if I % ITEM_MULTIPLE:
        raise ValueError(f"the kernel takes the item axis in multiples of "
                         f"{ITEM_MULTIPLE}: I={I}")
    for name, x in (("T", T), ("C", C), ("sizes", sizes)):
        if not x.is_contiguous() or (x is not sizes and x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous"
                             + ("" if x is sizes else " and 16-byte aligned"))
    out = torch.zeros(M, dtype=torch.int32, device=T.device)
    if N == 0 or M == 0:
        return out
    geom = geometry(N, M, I, sm_count(T.device.index or 0))
    lib, fn = _launcher()
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(T.data_ptr(), C.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), N, M, I, geom.warpgroups, geom.n,
                 geom.stages, stream)
    loader.check(lib, err, "support_count_int8 launch")
    support_count_int8.launches += 1
    return out


support_count_int8.launches = 0

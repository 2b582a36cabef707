"""Packed-bit rule matching: the kernel serving runs by default.

Replaces the reference's ``rule_scores_fused_pallas``
(``repro/kernels/rule_match/fused.py:48``, its ``pallas_call`` at
``:59``).  Items are packed 32 to a word (``pack_words``, shared with the
support-count kernel) and

  score[b, r] = [ Σ_w popc(Qw[b, w] & Aw[r, w]) == sizes[r] ] · conf[r]

is computed in one launch: the subset test, the ``== sizes`` filter and the
confidence weight never leave the chip as an unweighted match matrix.

At the serving shapes (a bucket of 8 or 64 queries against the index, 32
words a row) the work is small and the launch and one trip to memory set
the time.  The CUDA kernel (``csrc/rule_match_packed.cu``) computes the
AND-popcount on Hopper's binary tensor cores, ``wgmma`` m64nNk256 ``.b1
.and.popc``: a k256 step reads 32 bytes of a row as an int8 k32 step does,
so it is the int8 rule-match kernel (``csrc/rule_match_wgmma.cuh``: TMA
loads onto an ``mbarrier``, 128-byte-swizzled descriptors, either operand
on M, a cluster splitting long rows) with the b1 instruction and int32
sizes.  The rules are on M, 64 a CTA, and the batch on N;
:func:`geometry` picks N and the cluster.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import loader, sm_count
from repro_torch.kernels.rule_match import kernel as int8_kernel
from repro_torch.kernels.support_count.fused import pack_words, popcount32

# the wrapper's contract on the word axis: TMA rows of a multiple of 16
# bytes
WORD_MULTIPLE = 4

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


class Geometry(NamedTuple):
    """A launch of the kernel, whose CTAs each take 64 rules as wgmma's M
    operand: N (queries a tile) and the cluster size splitting a row's
    128-byte slabs."""
    n: int
    cluster: int

    def describe(self, B: int, R: int) -> str:
        tiles = -(-R // 64) * -(-B // self.n)
        return (f"rules on M, tiles of 64 rules x {self.n} queries, {tiles} "
                f"tiles x cluster {self.cluster} = {tiles * self.cluster} "
                "CTAs of 128 threads")


def geometry(B: int, R: int, W: int,
             sms: int = int8_kernel.H100_SMS) -> Geometry:
    """The launch geometry for [B, W] query words against [R, W] rule
    words: N is the batch rounded up to 8, 16, 32 or 64 (batches above 64
    take several query tiles).  With the b1 product the rules on M, one
    warpgroup a CTA, were the fastest layout at both of serving's buckets
    and for wide indexes (``tools/rule_match_packed_designs.py``), so the
    kernel has no other.  A row of 32 words is one 128-byte slab, so
    serving takes no cluster; a longer row is split over a cluster,
    doubling up to 8 while it divides the slabs evenly and the CTAs fit
    in one wave."""
    n = next(t for t in int8_kernel.QUERY_TILES if t >= min(B, 64))
    tiles = -(-R // 64) * -(-B // n)
    slabs = -(-4 * W // int8_kernel.SLAB)
    cluster = 1
    while (2 * cluster <= int8_kernel.CLUSTERS[-1]
           and slabs % (2 * cluster) == 0 and 2 * cluster * tiles <= sms):
        cluster *= 2
    return Geometry(n, cluster)


@functools.cache
def _launcher():
    lib = loader.load("rule_match_packed")
    fn = lib.rule_match_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
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


def check_kernel_layout(Qw, Aw, sizes, conf) -> None:
    """What the CUDA kernel asks of its inputs beyond their shapes and
    types: W % 4 == 0 (TMA rows of a multiple of 16 bytes), and every
    tensor contiguous and 16-byte aligned (TMA, and the epilogue's vector
    loads of sizes and conf)."""
    W = Qw.shape[1]
    if W % WORD_MULTIPLE:
        raise ValueError(f"the kernel's TMA rows need W % {WORD_MULTIPLE} "
                         f"== 0: W={W}")
    for name, x in (("Qw", Qw), ("Aw", Aw), ("sizes", sizes), ("conf", conf)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


def rule_scores_packed(Qw: torch.Tensor, Aw: torch.Tensor,
                       sizes: torch.Tensor,
                       conf: torch.Tensor) -> torch.Tensor:
    """Packed-popcount rule scores, ``[B, R]`` float32.

    Qw: [B, W] and Aw: [R, W] packed words (int32 bit patterns), sizes:
    [R] int32 (-1 on padded rows), conf: [R] float32.  A CUDA tensor goes
    through the kernel (``W % 4 == 0``, contiguous, 16-byte aligned) at
    :func:`geometry`'s launch geometry; a CPU tensor through the plain
    version.
    """
    _check_inputs(Qw, Aw, sizes, conf)
    if Qw.device.type == "cpu":
        return rule_scores_packed_plain(Qw, Aw, sizes, conf)
    if Qw.device.type != "cuda":
        raise ValueError(f"no rule_match_packed kernel for {Qw.device}")
    B, W = Qw.shape
    R = Aw.shape[0]
    check_kernel_layout(Qw, Aw, sizes, conf)
    out = torch.empty((B, R), dtype=torch.float32, device=Qw.device)
    if B == 0 or R == 0:
        return out
    geom = geometry(B, R, W, sm_count(Qw.device.index or 0))
    lib, fn = _launcher()
    with torch.cuda.device(Qw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(Qw.data_ptr(), Aw.data_ptr(), sizes.data_ptr(),
                 conf.data_ptr(), out.data_ptr(), B, R, W, geom.n,
                 geom.cluster, stream)
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

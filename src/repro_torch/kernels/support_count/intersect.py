"""Row-aligned tid-slab intersection: the Eclat plane's counting kernel.

Replaces the reference's ``intersect_count_pallas``
(``repro/kernels/support_count/intersect.py:63``).  Row m of A holds the
packed tid-list of one (k-1)-subset, row m of B that of its sibling from
the F_{k-1} ⋈ F_{k-1} join, and

  out[m] = Σ_w popc(A[m, w] & B[m, w])

is the candidate's support: a row-aligned op with no cross-row contraction,
so the tensor cores do not apply.

On H100 the kernel is bound by bytes: it reads 8·M·W bytes for M·W
AND+popcount+add triples, ten times more time at 3.35 TB/s than the
popcounts take.  At the dense mine's [128 × 3,200] tile those 3.3 MB take
less than a launch, so what is left is the latency from the launch to the
last byte.  The CUDA kernel (``csrc/intersect_count.cu``) gives each row
one owner, 512 threads (a warp for a short row), each of which issues all
its 16-byte loads of both slabs before its first popcount; the row's sum
meets through ``redux.sync`` and one shared-memory step, and the owner
stores it once: no atomics, no zeroing, a deterministic result.  Bulk
async copies into a ring of ``mbarrier`` stages, and rows split over a
cluster meeting in distributed shared memory, lost to it at every shape
(``tools/intersect_count_designs.py``).  :func:`geometry` picks the
threads a row.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.support_count.ref import intersect_count_ref


# the kernel's function as plain tensor ops ([M, W] int32 words -> [M]
# int32 counts): the oracle's arithmetic is already that
intersect_count_plain = intersect_count_ref


ROW_THREADS = (32, 512)        # threads that own a row
WARP_ROW_QUADS = 128           # a row of at most this many 16-byte quads
                               # goes to a warp


class Geometry(NamedTuple):
    """A launch of the kernel: the threads that own a row (a 256-thread
    CTA holds eight rows of 32)."""
    row_threads: int

    def describe(self, M: int, W: int) -> str:
        block = max(256, self.row_threads)
        ctas = -(-M // (block // self.row_threads))
        loads = -(-(W // 4) // self.row_threads)
        return (f"{self.row_threads} threads a row, {ctas} CTAs of {block} "
                f"threads, {loads} loads of each slab a thread")


def geometry(W: int) -> Geometry:
    """The launch geometry for slabs of W words: 512 threads own a row of
    more than 512 words, a warp a shorter one.  512 was the fastest width
    at the dense tile, the whole slab and the retail tile
    (``tools/intersect_count_designs.py``), ahead of 1,024 and of 256."""
    return Geometry(32 if W // 4 <= WARP_ROW_QUADS else 512)


@functools.cache
def _launcher():
    lib = loader.load("intersect_count")
    fn = lib.intersect_count_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(A, B):
    if A.dim() != 2 or A.shape != B.shape:
        raise ValueError(f"want A and B of one [M, W] shape, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    for name, x in (("A", A), ("B", B)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if B.device != A.device:
        raise ValueError(f"B is on {B.device}, A on {A.device}")


def intersect_count_words(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Intersection counts ``[M]`` int32 of two [M, W] slabs of packed
    words (int32 bit patterns).  A CUDA tensor goes through the kernel
    (``W % 4 == 0``, contiguous, 16-byte aligned) at :func:`geometry`'s
    launch geometry; a CPU tensor through the plain version.
    """
    _check_inputs(A, B)
    if A.device.type == "cpu":
        return intersect_count_plain(A, B)
    if A.device.type != "cuda":
        raise ValueError(f"no intersect_count kernel for {A.device}")
    M, W = A.shape
    if W % 4:
        raise ValueError(f"the kernel reads 4 words at a time: W={W}")
    for name, x in (("A", A), ("B", B)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty(M, dtype=torch.int32, device=A.device)
    if M == 0:
        return out
    geom = geometry(W)
    lib, fn = _launcher()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(A.data_ptr(), B.data_ptr(), out.data_ptr(), M, W,
                 geom.row_threads, stream)
    loader.check(lib, err, "intersect_count launch")
    intersect_count_words.launches += 1
    return out


intersect_count_words.launches = 0

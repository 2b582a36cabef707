"""Int8 tensor-core rule matching: serving's ``mxu`` variant.

Replaces the reference's ``rule_scores_pallas``
(``repro/kernels/rule_match/kernel.py:72``), which runs the antecedent
containment test as an int8 matmul on the TPU's matrix unit:

  score[b, r] = [ Σ_i Q[b, i]·A[r, i] == sizes[r] ] · conf[r]

At the serving shapes (a batch of 8 or 64 queries against the whole
index) the bytes bound it on H100: one read of the [R, I] antecedents and
one write of the [B, R] float scores outweigh 2·B·R·I int8 operations at
1,979 dense TOP/s.  At the serving shape those bytes take 0.36 µs, so the
kernel is built against latency: ``wgmma`` m64nNk32 s8 products, with a
bucket of 64 queries as the M operand and 32-rule tiles as N, or else the
rules as M and the batch (rounded up to 8, 16, 32 or 64) as N; one thread
loads every 128-item slab of both operands at once by TMA onto one
``mbarrier`` a slab, and a tile's item axis is split over a cluster of up
to 8 CTAs whose int32 partials meet in distributed shared memory before
the ``== sizes`` compare and the ``conf`` weight.  :func:`geometry` picks
the launch geometry; ``csrc/rule_match_int8.cu`` has the design and the
times that chose between the two layouts.  It takes 0.0052 ms at the
serving shape [64 × 896 × 1,024], 0.0047 at bucket 8 and 0.0092 at
[64 × 16,384 × 1,024], against 0.0155, 0.0214 and 0.0240 for
``torch._int_mm`` plus the compare and weight (chip_smoke, NVIDIA H100
80GB HBM3, 700.00 W).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import loader, sm_count
from repro_torch.kernels.rule_match.ref import rule_scores_ref
from repro_torch.kernels.support_count.ref import MAX_EXACT_ITEMS

# the wrapper's contract on the item axis (the kernel's TMA loads need
# rows of a multiple of 16 bytes and zero-fill a ragged last slab)
ITEM_MULTIPLE = 64
SLAB = 128            # items a TMA box and a swizzled shared-memory row hold
QUERY_TILES = (8, 16, 32, 64)   # wgmma N with the rules on M: queries a tile
RULE_TILE = 32                  # wgmma N with the queries on M: rules a tile
CLUSTERS = (1, 2, 4, 8)         # CTAs splitting a tile's item axis
H100_SMS = 132


class Geometry(NamedTuple):
    """A launch of the kernel: warpgroups a CTA (64 rows of wgmma's M
    operand each), N (rows of the other operand a tile), the cluster size
    splitting a tile's item axis, and which operand is M: the rules (N
    queries a tile) or the queries (N rules a tile)."""
    warpgroups: int
    n: int
    cluster: int
    rules_on_m: bool = True

    def describe(self, B: int, R: int, I: int) -> str:
        m = 64 * self.warpgroups
        rules, queries = (m, self.n) if self.rules_on_m else (self.n, m)
        tiles = -(-R // rules) * -(-B // queries)
        return (f"{'rules' if self.rules_on_m else 'queries'} on M, tiles "
                f"of {rules} rules x {queries} queries, {tiles} tiles x "
                f"cluster {self.cluster} = {tiles * self.cluster} CTAs of "
                f"{128 * self.warpgroups} threads")


def geometry(B: int, R: int, I: int, sms: int = H100_SMS) -> Geometry:
    """The launch geometry for [B, I] queries against [R, I] rules.

    A batch of more than 32 queries is wgmma's M operand, 64 queries a
    tile against 32-rule tiles, when those tiles fit in one wave of
    ``sms`` CTAs (the faster layout at a bucket of 64 against a small
    index).  Otherwise the rules are M and N is the batch rounded up to 8,
    16, 32 or 64 (batches above 64 take several query tiles); a CTA takes
    128 rules (two warpgroups) once 64-rule tiles would overfill one wave,
    so a wide index is read once in one wave.  The cluster then doubles,
    up to 8 and up to one CTA a 128-item slab, while the CTAs still fit in
    one wave.
    """
    if B > 32 and -(-R // RULE_TILE) * -(-B // 64) <= sms:
        geom, tiles = Geometry(1, RULE_TILE, 1, False), \
            -(-R // RULE_TILE) * -(-B // 64)
    else:
        n = next(t for t in QUERY_TILES if t >= min(B, QUERY_TILES[-1]))
        q_tiles = -(-B // n)
        warpgroups = 2 if -(-R // 64) * q_tiles > sms else 1
        geom = Geometry(warpgroups, n, 1)
        tiles = -(-R // (64 * warpgroups)) * q_tiles
    slabs = -(-I // SLAB)
    cluster = 1
    while (2 * cluster <= CLUSTERS[-1] and 2 * cluster <= slabs
           and 2 * cluster * tiles <= sms):
        cluster *= 2
    return geom._replace(cluster=cluster)


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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
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
    (``I % 64 == 0``, contiguous, 16-byte aligned) at :func:`geometry`'s
    launch geometry; a CPU tensor through the plain version.
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
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    out = torch.empty((B, R), dtype=torch.float32, device=Q.device)
    if B == 0 or R == 0:
        return out
    geom = geometry(B, R, I, sm_count(Q.device.index or 0))
    lib, fn = _launcher()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(Q.data_ptr(), A.data_ptr(), sizes.data_ptr(),
                 conf.data_ptr(), out.data_ptr(), B, R, I,
                 int(geom.rules_on_m), geom.warpgroups, geom.n, geom.cluster,
                 stream)
    loader.check(lib, err, "rule_match_int8 launch")
    rule_scores_int8.launches += 1
    return out


rule_scores_int8.launches = 0

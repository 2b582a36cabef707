"""Time the intersect kernel's launch geometries at the vertical plane's
shapes, beside the bulk-copy design it was chosen over and any earlier
kernel.

``src/repro_torch/csrc/intersect_count.cu`` takes a geometry at launch:
the threads that own a row (32 or 512), each issuing its 16-byte loads
of a chunk of both slabs before its first popcount.
``intersect.geometry`` picks one a shape.  This script launches every
geometry at three shapes, the dense Eclat mine's [128 x 3,200] tile (29
launches a mine), the whole k = 2 slab [2,176 x 3,200] and a retail tile
[640 x 2,816] (41 launches a sparse mine); the bulk-copy design
(``tools/intersect_count_bulk_copies.cu``: one thread's ``cp.async.bulk``
copies into a ring of mbarrier stages, rows a CTA, a cluster splitting
each row) at one row a CTA without a cluster, at the row split over a
cluster of 2 and 4, and at several rows a CTA; and any other source with
the one-owner-a-row kernel's earlier C entry point
(``intersect_count_launch(A, B, out, M, W, stream)``, e.g. a parent
commit's ``intersect_count.cu`` written under ``build/`` first).  Each is
held exactly equal to the plain version on random words (bit 31
included), then all are timed in turns over several rounds (each round's
order the reverse of the last), beside an empty launch
(``torch.cuda._sleep(0)``).  Needs an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/intersect_count_designs.py \\
        [--rounds N] [--out FILE] [NAME=PATH ...]

Prints the card's name and power limit, then at each shape each launch's
median, fastest and slowest time over the rounds, marking the one
``intersect.geometry`` picks.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import loader
from repro_torch.kernels.support_count import intersect

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
OUT_DIR = ROOT / "build" / "intersect_count_designs"
# (rows, words): a dense tile, the whole k = 2 slab, a retail tile
SHAPES = ((128, 3200), (2176, 3200), (640, 2816))
LAUNCHES = 100                  # launches a timing, queued behind a spin
HBM_BYTES_PER_S = 3.35e12


# the bulk-copy design's build constants (tools/intersect_count_bulk_copies.cu)
BULK_MAX_CHUNK_QUADS = 1024
BULK_MAX_STAGES = 8
SMEM_LIMIT = 232448


class BulkGeometry(NamedTuple):
    """A launch of the bulk-copy design: consecutive rows a CTA, the
    cluster of CTAs splitting each row's quads, the chunks its ring keeps
    in flight."""
    rows: int
    cluster: int
    stages: int

    def describe(self, M: int) -> str:
        return (f"{self.rows} rows a CTA, cluster {self.cluster}: "
                f"{-(-M // self.rows) * self.cluster} CTAs, {self.stages} "
                "stages")


def bulk_geometry(rows, cluster, W):
    """The geometry with the fullest ring that fits in shared memory."""
    share = -(-(W // 4) // cluster)
    chunk = min(share, BULK_MAX_CHUNK_QUADS)
    units = rows * -(-share // chunk)
    stages = max(s for s in range(1, min(BULK_MAX_STAGES, units) + 1)
                 if s * chunk * 32 + 8 * s + 4 * rows <= SMEM_LIMIT)
    return BulkGeometry(rows, cluster, stages)


def nvcc(lib, src, entry):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([loader._nvcc(), *loader.NVCC_FLAGS, "-I",
                           str(loader.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return getattr(ctypes.CDLL(str(lib)), entry)


def shipped(A, B, geom):
    """One launch of the shipped kernel at ``geom``."""
    _, fn = intersect._launcher()
    M, W = A.shape
    out = torch.empty(M, dtype=torch.int32, device=A.device)
    err = fn(A.data_ptr(), B.data_ptr(), out.data_ptr(), M, W,
             geom.row_threads, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{geom}: CUDA error {err}")
    return out


def bulk_source():
    """``run(A, B, geom)`` for the bulk-copy design."""
    fn = nvcc(OUT_DIR / "libbulk_copies.so",
              TOOLS / "intersect_count_bulk_copies.cu",
              "intersect_count_bulk_launch")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(A, B, geom):
        M, W = A.shape
        out = torch.empty(M, dtype=torch.int32, device=A.device)
        err = fn(A.data_ptr(), B.data_ptr(), out.data_ptr(), M, W,
                 geom.rows, geom.cluster, geom.stages,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bulk copies {geom}: CUDA error {err}")
        return out
    return run


def earlier_source(name, path):
    """``run(A, B)`` for a source with the earlier C entry point."""
    fn = nvcc(OUT_DIR / f"lib{name.replace(' ', '_')}.so", path,
              "intersect_count_launch")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(A, B):
        M, W = A.shape
        out = torch.empty(M, dtype=torch.int32, device=A.device)
        err = fn(A.data_ptr(), B.data_ptr(), out.data_ptr(), M, W,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out
    return run


def bulk_geometries(M, W, sms):
    """The bulk-copy design at one row a CTA with no cluster and with
    clusters of 2 and 4, and at the rows that spread M over the SMs."""
    out = [bulk_geometry(1, c, W) for c in (1, 2, 4) if c <= W // 4]
    if M > sms:
        out.append(bulk_geometry(-(-M // sms), 1, W))
    return out


def words(M, W, rng):
    """Random words, about half with bit 31 set, on the card."""
    return torch.from_numpy(rng.integers(0, 2**32, size=(M, W),
                                         dtype=np.uint32).view(np.int32)
                            ).cuda()


def device_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out", type=Path, help="write the results as JSON")
    ap.add_argument("extra", nargs="*", metavar="NAME=PATH",
                    help="another source with the one-owner-a-row C entry "
                         "point")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    bulk = bulk_source()
    others = {}
    for spec in args.extra:
        name, _, path = spec.partition("=")
        others[name] = earlier_source(name, Path(path).resolve())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(4)
    results = {}
    for M, W in SHAPES:
        A, B = words(M, W, rng), words(M, W, rng)
        A[0, : W // 2] = -1                      # all 32 bits of a word
        picked = intersect.geometry(W)
        want = intersect.intersect_count_plain(A, B)
        designs = {}
        for t in intersect.ROW_THREADS:
            g = intersect.Geometry(t)
            designs["shipped, " + g.describe(M, W)
                    + (" [picked]" if g == picked else "")] = (
                lambda g=g: shipped(A, B, g))
        designs["shipped, through the wrapper"] = (
            lambda: intersect.intersect_count_words(A, B))
        for g in bulk_geometries(M, W, sms):
            designs["bulk copies, " + g.describe(M)] = (
                lambda g=g: bulk(A, B, g))
        designs.update({name: (lambda run=run: run(A, B))
                        for name, run in others.items()})
        for name, fn in designs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at [{M}, {W}] differs from "
                                     "the plain version")
        designs["empty launch (torch.cuda._sleep(0))"] = (
            lambda: torch.cuda._sleep(0))
        times = {name: [] for name in designs}
        order = list(designs)
        for _ in range(args.rounds):
            for name in order:
                times[name].append(device_ms(designs[name]))
            order.reverse()
        bound = (8 * M * W + 4 * M) / HBM_BYTES_PER_S * 1e3
        print(f"[{M} x {W} words] x 2, exact; byte bound {bound:.5f} ms; "
              f"ms over {args.rounds} rounds of {LAUNCHES} launches "
              "(median, fastest, slowest):")
        for name, ts in sorted(times.items(),
                               key=lambda kv: statistics.median(kv[1])):
            print(f"  {name}: {statistics.median(ts):.5f}, {min(ts):.5f}, "
                  f"{max(ts):.5f}")
        results[f"{M}x{W}"] = dict(bound_ms=bound, ms=times)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, shapes=results),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the int8 support-count kernel's launch geometries at each counting
round's shape, beside the kernel it replaced and ``torch._int_mm``.

``src/repro_torch/csrc/support_count_int8.cu`` takes a geometry at launch:
consumer warpgroups a CTA (64 transactions each), candidates a tile (64,
128 or 256), and the slabs its ring keeps in flight.  ``kernel.geometry``
picks one a shape.  This script launches every geometry at the dense
mine's four counting rounds, one transaction tile [3,128 x 1,024] against
M = 2,176, 256, 128 and 128 candidates (so three shapes), holds each
launch exactly equal to the plain version, and times them in turns over
several rounds (each round's order the reverse of the last), with
``torch._int_mm`` plus the compare and sum and any other source with the
kernel's first C entry point (``support_count_int8_launch(T, C, sizes, out, N, M, I, stream)``,
e.g. a parent commit's ``support_count_int8.cu`` written under
``build/`` first).  Needs an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/support_count_int8_designs.py \\
        [--rounds N] [--out FILE] [NAME=PATH ...]

Prints the card's name and power limit, then at each shape each launch's
median, fastest and slowest time over the rounds, marking the one
``kernel.geometry`` picks.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import loader
from repro_torch.kernels.support_count import kernel

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "support_count_int8_designs"
ITEMS = 1024
# (transactions, candidates): one of the dense mine's 32 tiles against a
# round's candidates (k = 2, 3, then 4 and 5)
SHAPES = ((3128, 2176), (3128, 256), (3128, 128))
LAUNCHES = 100                  # launches a timing, queued behind a spin


def launch(T, C, sizes, geom):
    """One launch of the shipped kernel at ``geom``."""
    _, fn = kernel._launcher()
    N, I = T.shape
    out = torch.zeros(C.shape[0], dtype=torch.int32, device=T.device)
    err = fn(T.data_ptr(), C.data_ptr(), sizes.data_ptr(), out.data_ptr(),
             N, C.shape[0], I, geom.warpgroups, geom.n, geom.stages,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{geom}: CUDA error {err}")
    return out


def other_source(name, path):
    """A launcher for another source with the first kernel's C entry
    point, built with the port's flags."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"lib{name.replace(' ', '_')}.so"
    proc = subprocess.run([loader._nvcc(), *loader.NVCC_FLAGS, "-o",
                           str(lib), str(path)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).support_count_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(T, C, sizes):
        N, I = T.shape
        out = torch.zeros(C.shape[0], dtype=torch.int32, device=T.device)
        err = fn(T.data_ptr(), C.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), N, C.shape[0], I,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out
    return run


def geometries():
    """Every geometry the kernel takes at an item axis of ITEMS: each
    warpgroup count and tile width, with the ring ``geometry`` would give
    it and with 2 stages."""
    slabs = -(-ITEMS // kernel.SLAB)
    out = []
    for wg in (1, 2):
        for n in kernel.TILE_WIDTHS:
            full = min(slabs, kernel.max_stages(wg, n))
            for stages in sorted({full, min(2, full)}):
                out.append(kernel.Geometry(wg, n, stages))
    return out


def inputs(N, M, seed):
    """Transactions of density 0.05 and candidates of 2-3 items drawn from
    random transactions (one empty), as a mining round has them."""
    rng = np.random.default_rng(seed)
    T = (rng.random((N, ITEMS)) < 0.05).astype(np.int8)
    C = np.zeros((M, ITEMS), np.int8)
    for m in range(1, M):
        items = np.flatnonzero(T[rng.integers(N)])
        if len(items) < 2:
            items = rng.choice(ITEMS, 3, replace=False)
        C[m, rng.choice(items, min(len(items), rng.integers(2, 4)),
                        replace=False)] = 1
    sizes = C.sum(1, dtype=np.int32)
    return [torch.from_numpy(x).cuda() for x in (T, C, sizes)]


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
                    help="another source with the first kernel's C entry "
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
    others = {}
    for spec in args.extra:
        name, _, path = spec.partition("=")
        others[name] = other_source(name, Path(path).resolve())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for N, M in SHAPES:
        T, C, sizes = inputs(N, M, N + M)
        picked = kernel.geometry(N, M, ITEMS, sms)
        want = kernel.support_count_int8_plain(T, C, sizes)

        def int_mm(T=T, C=C, sizes=sizes):
            dots = torch._int_mm(T, C.t())
            return (dots == sizes[None, :]).sum(dim=0, dtype=torch.int32)
        designs = {g.describe(N, M, ITEMS)
                   + (" [picked]" if g == picked else ""):
                   (lambda g=g: launch(T, C, sizes, g))
                   for g in geometries()}
        if picked not in geometries():
            designs[picked.describe(N, M, ITEMS) + " [picked]"] = (
                lambda: launch(T, C, sizes, picked))
        designs.update({name: (lambda run=run: run(T, C, sizes))
                        for name, run in others.items()})
        designs["torch._int_mm + compare and sum"] = int_mm
        for name, fn in designs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at [{N}, {M}] differs from "
                                     "the plain version")
        if not (want > 0).any():
            raise AssertionError(f"no candidate is supported at [{N}, {M}]")
        times = {name: [] for name in designs}
        order = list(designs)
        for _ in range(args.rounds):
            for name in order:
                times[name].append(device_ms(designs[name]))
            order.reverse()
        bound = max(2 * N * M * ITEMS / 1979e12,
                    (N * ITEMS + M * ITEMS + 8 * M) / 3.35e12) * 1e3
        print(f"[{N} x {ITEMS}] x [{M} x {ITEMS}], exact; bound "
              f"{bound:.5f} ms; ms over {args.rounds} rounds of {LAUNCHES} "
              "launches (median, fastest, slowest):")
        for name, ts in sorted(times.items(),
                               key=lambda kv: statistics.median(kv[1])):
            print(f"  {name}: {statistics.median(ts):.5f}, {min(ts):.5f}, "
                  f"{max(ts):.5f}")
        results[f"{N}x{M}"] = dict(bound_ms=bound, ms=times)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, items=ITEMS,
                                            shapes=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

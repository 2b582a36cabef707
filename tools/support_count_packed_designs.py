"""Time the packed support-count kernel's launch geometries at each counting
round's shape, beside the CUDA-core design it replaced and the int8 kernel.

``src/repro_torch/csrc/support_count_packed.cu`` runs the kernel of
``csrc/support_count_wgmma.cuh`` with the binary tensor-core product
(``wgmma`` m64nNk256 ``.b1 .and.popc``) on tiles of 64 transactions by 64
candidates, a CTA walking ``tiles`` transaction tiles through a ring of
two slabs; ``fused.geometry`` picks ``tiles`` a shape.  This script
launches a spread of geometries at the dense mine's counting rounds, one
transaction tile [3,128 x 32 words] against M = 2,176, 256 and 128
candidates: the shipped launch, and every tile the shared kernel takes
(one or two consumer warpgroups by 64, 128 or 256 candidates, built from
``tools/support_count_packed_tiles.cu``), each walking 1, 2 or 4
transaction tiles a CTA.  It holds each launch exactly equal to the plain
version and times them in turns over several rounds (each round's order
the reverse of the last), beside the CUDA-core design
(``tools/support_count_packed_cuda_cores.cu``), any other source with its
C entry point (``support_count_packed_launch(Tw, Cw, sizes, out, N, M, W,
stream)``, e.g. a parent commit's ``support_count_packed.cu`` written
under ``build/`` first), the int8 kernel through its wrapper at the same
shape ([3,128 x 1,024] int8), and an empty launch
(``torch.cuda._sleep(0)``, the floor of a launch queued behind others).
Every launch but the empty one comes with the zeroing of ``out``, as the
wrappers' do.  Needs an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/support_count_packed_designs.py \\
        [--rounds N] [--out FILE] [NAME=PATH ...]

Prints the card's name and power limit, then at each shape each launch's
median, fastest and slowest time over the rounds.
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
from repro_torch.kernels.support_count import fused, kernel

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
OUT_DIR = ROOT / "build" / "support_count_packed_designs"
ITEMS = 1024                    # 32 words a row
# (transactions, candidates): one of the dense mine's 32 tiles against a
# round's candidates (k = 2, 3, then 4 and 5)
SHAPES = ((3128, 2176), (3128, 256), (3128, 128))
LAUNCHES = 100                  # launches a timing, queued behind a spin
B1_OPS_PER_S = 7862e12          # chip_smoke.py's measured b1 rate


def launch(Tw, Cw, sizes, geom):
    """One launch of the shipped kernel at ``geom``."""
    _, fn = fused._launcher()
    N, W = Tw.shape
    out = torch.zeros(Cw.shape[0], dtype=torch.int32, device=Tw.device)
    err = fn(Tw.data_ptr(), Cw.data_ptr(), sizes.data_ptr(), out.data_ptr(),
             N, Cw.shape[0], W, geom.tiles,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{geom}: CUDA error {err}")
    return out


def nvcc(name, path):
    """The library built from ``path`` with the port's flags."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"lib{name.replace(' ', '_')}.so"
    proc = subprocess.run([loader._nvcc(), *loader.NVCC_FLAGS, "-I",
                           str(loader.CSRC), "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def tiles_source():
    """``run(Tw, Cw, sizes, wg, n, tiles, stages)`` for every tile of the
    shared kernel, built from ``tools/support_count_packed_tiles.cu``."""
    fn = nvcc("tiles", TOOLS / "support_count_packed_tiles.cu"
              ).support_count_packed_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(Tw, Cw, sizes, wg, n, tiles, stages):
        N, W = Tw.shape
        out = torch.zeros(Cw.shape[0], dtype=torch.int32, device=Tw.device)
        err = fn(Tw.data_ptr(), Cw.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), N, Cw.shape[0], W, wg, n, tiles, stages,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tile {wg} x {n}, {tiles}, {stages}: CUDA "
                               f"error {err}")
        return out
    return run


def cuda_core_source(name, path):
    """A launcher for a source with the CUDA-core design's C entry
    point."""
    fn = nvcc(name, path).support_count_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(Tw, Cw, sizes):
        N, W = Tw.shape
        out = torch.zeros(Cw.shape[0], dtype=torch.int32, device=Tw.device)
        err = fn(Tw.data_ptr(), Cw.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), N, Cw.shape[0], W,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out
    return run


def geometries():
    """(warpgroups, candidates, tiles a CTA, stages): every tile at 1, 2
    and 4 transaction tiles a CTA through a ring of two, and the shipped
    64 x 64 tile walking 2 to 8 tiles through deeper rings."""
    out = [(wg, n, tiles, 2) for wg in (1, 2) for n in kernel.TILE_WIDTHS
           for tiles in (1, 2, 4)]
    out += [(1, 64, tiles, stages) for tiles in (2, 4, 8)
            for stages in (3, 4, 6, 8) if stages <= tiles]
    return out


def inputs(N, M, seed):
    """Transactions of density 0.05 and candidates of 2-3 items drawn from
    random transactions (one empty), as a mining round has them, as int8
    and as packed words."""
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
    T, C, sizes = (torch.from_numpy(x).cuda() for x in (T, C, sizes))
    return T, C, fused.pack_words(T), fused.pack_words(C), sizes


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
                    help="another source with the CUDA-core design's C "
                         "entry point")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    tiled = tiles_source()
    others = {"CUDA cores (tools/support_count_packed_cuda_cores.cu)":
              cuda_core_source("cuda_cores", TOOLS /
                               "support_count_packed_cuda_cores.cu")}
    for spec in args.extra:
        name, _, path = spec.partition("=")
        others[name] = cuda_core_source(name, Path(path).resolve())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for N, M in SHAPES:
        T, C, Tw, Cw, sizes = inputs(N, M, N + M)
        W = Tw.shape[1]
        picked = fused.geometry(N, M, W, sms)
        want = fused.support_count_packed_plain(Tw, Cw, sizes)
        designs = {
            f"b1 wgmma, tiles of {64 * wg} transactions x {n} candidates, "
            f"{tiles} a CTA, {stages} stages": (
                lambda a=(wg, n, tiles, stages): tiled(Tw, Cw, sizes, *a))
            for wg, n, tiles, stages in geometries()}
        designs["b1 wgmma shipped, " + picked.describe(N, M, W)] = (
            lambda: launch(Tw, Cw, sizes, picked))
        designs["b1 wgmma shipped, through the wrapper"] = (
            lambda: fused.support_count_packed(Tw, Cw, sizes))
        designs.update({name: (lambda run=run: run(Tw, Cw, sizes))
                        for name, run in others.items()})
        designs["int8 kernel through its wrapper, [3128 x 1024] int8"] = (
            lambda: kernel.support_count_int8(T, C, sizes))
        for name, fn in designs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at [{N}, {M}] differs from "
                                     "the plain version")
        if not (want > 0).any():
            raise AssertionError(f"no candidate is supported at [{N}, {M}]")
        designs["empty launch (torch.cuda._sleep(0))"] = (
            lambda: torch.cuda._sleep(0))
        times = {name: [] for name in designs}
        order = list(designs)
        for _ in range(args.rounds):
            for name in order:
                times[name].append(device_ms(designs[name]))
            order.reverse()
        bound = max(N * M * W * 32 / B1_OPS_PER_S,
                    (N * W * 4 + M * W * 4 + 8 * M) / 3.35e12) * 1e3
        print(f"[{N} x {W} words] x [{M} x {W} words], exact; bound "
              f"{bound:.5f} ms; ms over {args.rounds} rounds of {LAUNCHES} "
              "launches (median, fastest, slowest):")
        for name, ts in sorted(times.items(),
                               key=lambda kv: statistics.median(kv[1])):
            print(f"  {name}: {statistics.median(ts):.5f}, {min(ts):.5f}, "
                  f"{max(ts):.5f}")
        results[f"{N}x{M}"] = dict(bound_ms=bound, ms=times)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, words=ITEMS // 32,
                                            shapes=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

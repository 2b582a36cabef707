"""Time the packed rule-match designs at serving's shapes, and measure the
binary tensor-core rate that bounds them.

Three steps, in one call on the card:

1. the probe: does ``nvcc`` assemble ``wgmma ... .b1.b1.and.popc`` for
   ``sm_90a`` (``tools/wgmma_b1_probe.cu``)?  Also lists the b1 products
   in CUTLASS's headers where they are installed;
2. the rates: ``tools/wgmma_rate.cu`` runs back-to-back m64n256 products
   on shared-memory tiles on every SM, s8 (against the published 1,979
   TOP/s, to say how near its peak such a loop runs) and b1 (bit
   AND-popcount-adds a second, the rate ``chip_smoke.py`` bounds the
   packed kernels with);
3. the designs, at [64 x 896 x 32 words], [8 x 896 x 32] (serving's
   buckets against the dense mine's index), [64 x 4,096 x 32] and [64 x
   16,384 x 32] (wider indexes): (a) the b1 ``wgmma`` kernel at the
   layout that ``csrc/rule_match_packed.cu`` ships (the rules on M, one
   warpgroup of 64 a CTA) and at those it left out (the queries on M,
   two warpgroups of rules), all built from
   ``tools/rule_match_packed_layouts.cu``, and the shipped kernel itself
   through its wrapper; (b) the CUDA-core design
   (``tools/rule_match_packed_cuda_cores.cu``); and any other source with
   that design's C entry point (``rule_match_packed_launch(Qw, Aw, sizes,
   conf, out, B, R, W, stream)``, e.g. a parent commit's
   ``rule_match_packed.cu`` written under ``build/`` first).  Each is held
   bit-equal to the plain version, then all are timed in turns over
   several rounds (each round's order the reverse of the last), beside an
   empty launch (``torch.cuda._sleep(0)``, the floor of a launch queued
   behind others).

Needs an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/rule_match_packed_designs.py \\
        [--rounds N] [--out FILE] [NAME=PATH ...]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import loader
from repro_torch.kernels.rule_match import fused
from repro_torch.kernels.rule_match import kernel as int8_kernel
from repro_torch.kernels.support_count.fused import pack_words

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
OUT_DIR = ROOT / "build" / "rule_match_packed_designs"
ITEMS = 1024                    # 32 words a row
SHAPES = ((64, 896), (8, 896), (64, 4096), (64, 16_384))
LAUNCHES = 100                  # launches a timing, queued behind a spin
RATE_ITERS = 20_000             # slabs of 4 products a warpgroup


def nvcc(out, src, *flags):
    cmd = [loader._nvcc(), *loader.NVCC_FLAGS, "-I", str(loader.CSRC),
           *flags, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def probe() -> bool:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [loader._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-cubin", "-o", str(OUT_DIR / "probe.cubin"),
           str(TOOLS / "wgmma_b1_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    ok = proc.returncode == 0
    print(f"probe: nvcc {'assembles' if ok else 'refuses'} wgmma "
          "m64n8k256.s32.b1.b1.and.popc for sm_90a"
          + ("" if ok else ":\n" + proc.stdout + proc.stderr))
    hits = []
    for path in sorted(glob.glob("/usr/local/cutlass/include/cute/arch/"
                                 "mma_sm90_gmma*.hpp")):
        with open(path) as f:
            hits += [f"{Path(path).name}: {line.strip()}" for line in f
                     if ".b1.b1" in line]
    print(f"CUTLASS: {len(hits)} lines name a b1 wgmma"
          + (f", e.g. {hits[0]}" if hits else ""))
    return ok


def rates(sms):
    """Tensor-core rates of a loop of m64n256 products on every SM:
    {"s8": int8 operations/s, "b1": bit AND-popcount-adds/s}."""
    lib = OUT_DIR / "libwgmma_rate.so"
    rc, log = nvcc(lib, TOOLS / "wgmma_rate.cu")
    if rc:
        raise RuntimeError(f"nvcc failed for wgmma_rate.cu:\n{log}")
    fn = ctypes.CDLL(str(lib)).wgmma_rate_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.empty(sms * 256, dtype=torch.int32, device="cuda")
    found = {}
    for kind, name, per_instr in ((0, "s8", 2 * 64 * 256 * 32),
                                  (1, "b1", 64 * 256 * 256)):
        def run(iters):
            err = fn(kind, iters, sms, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"wgmma_rate {name}: CUDA error {err}")
        run(100)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        best = float("inf")
        for _ in range(3):
            start.record()
            run(RATE_ITERS)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        ops = sms * 2 * RATE_ITERS * 4 * per_instr   # 2 warpgroups an SM
        found[name] = ops / best
    print(f"rates on {sms} SMs: s8 {found['s8'] / 1e12:.0f} TOP/s "
          f"({found['s8'] / 1979e12:.0%} of the published 1,979), b1 "
          f"{found['b1'] / 1e12:.0f} T bit-ops/s")
    return found


def cuda_core_source(name, path):
    """A launcher for a source with the CUDA-core design's C entry
    point."""
    lib = OUT_DIR / f"lib{name.replace(' ', '_')}.so"
    rc, log = nvcc(lib, path)
    if rc:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    fn = ctypes.CDLL(str(lib)).rule_match_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(Qw, Aw, sizes, conf):
        B, W = Qw.shape
        out = torch.empty((B, Aw.shape[0]), dtype=torch.float32,
                          device=Qw.device)
        err = fn(Qw.data_ptr(), Aw.data_ptr(), sizes.data_ptr(),
                 conf.data_ptr(), out.data_ptr(), B, Aw.shape[0], W,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out
    return run


def layouts_source():
    """A launcher for every layout of the b1 kernel, built from
    ``tools/rule_match_packed_layouts.cu``: ``run(Qw, Aw, sizes, conf,
    geom)`` with ``geom`` an int8 rule-match ``Geometry``."""
    lib = OUT_DIR / "librule_match_packed_layouts.so"
    rc, log = nvcc(lib, TOOLS / "rule_match_packed_layouts.cu")
    if rc:
        raise RuntimeError(f"nvcc failed for rule_match_packed_layouts.cu:"
                           f"\n{log}")
    fn = ctypes.CDLL(str(lib)).rule_match_packed_layouts_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(Qw, Aw, sizes, conf, geom):
        B, W = Qw.shape
        out = torch.empty((B, Aw.shape[0]), dtype=torch.float32,
                          device=Qw.device)
        err = fn(Qw.data_ptr(), Aw.data_ptr(), sizes.data_ptr(),
                 conf.data_ptr(), out.data_ptr(), B, Aw.shape[0], W,
                 int(geom.rules_on_m), geom.warpgroups, geom.n, geom.cluster,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{geom}: CUDA error {err}")
        return out
    return run


def layouts(B, R):
    """Both layouts at batch B: the rules on M (one warpgroup, and two
    where 64-rule tiles overfill a wave) and the queries on M; a row of 32
    words is one slab, so no cluster."""
    n = next(t for t in int8_kernel.QUERY_TILES if t >= min(B, 64))
    out = [int8_kernel.Geometry(1, n, 1),
           int8_kernel.Geometry(1, int8_kernel.RULE_TILE, 1, False)]
    if -(-R // 64) * -(-B // n) > 132:
        out.append(int8_kernel.Geometry(2, n, 1))
    return out


def inputs(B, R, seed):
    """Baskets of density 0.3 and antecedents of 1-3 random items (one
    empty), as the card tests draw them, packed into words."""
    rng = np.random.default_rng(seed)
    Q = (rng.random((B, ITEMS)) < 0.3).astype(np.int8)
    A = np.zeros((R, ITEMS), np.int8)
    cols = rng.integers(0, ITEMS, (R, 3))
    keep = np.arange(3)[None, :] < rng.integers(1, 4, (R, 1))
    A[np.repeat(np.arange(R)[:, None], 3, 1)[keep], cols[keep]] = 1
    A[0] = 0
    sizes = A.sum(1).astype(np.int32)
    conf = rng.random(R).astype(np.float32)
    Q, A, sizes, conf = (torch.from_numpy(x).cuda()
                         for x in (Q, A, sizes, conf))
    return pack_words(Q), pack_words(A), sizes, conf


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
    ap.add_argument("--rounds", type=int, default=9)
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assembles = probe()
    found = rates(sms) if assembles else {}
    launch = layouts_source() if assembles else None
    others = {"(b) CUDA cores": cuda_core_source(
        "cuda_cores", TOOLS / "rule_match_packed_cuda_cores.cu")}
    for spec in args.extra:
        name, _, path = spec.partition("=")
        others[name] = cuda_core_source(name, Path(path).resolve())
    results = {}
    for B, R in SHAPES:
        Qw, Aw, sizes, conf = inputs(B, R, B + R)
        W = Qw.shape[1]
        picked = fused.geometry(B, R, W, sms)
        want = fused.rule_scores_packed_plain(Qw, Aw, sizes, conf)
        designs = {}
        if assembles:
            designs.update({
                "(a) b1 wgmma, " + g.describe(B, R, 4 * W):
                (lambda g=g: launch(Qw, Aw, sizes, conf, g))
                for g in layouts(B, R)})
            designs["(a) b1 wgmma shipped, " + picked.describe(B, R)] = (
                lambda: fused.rule_scores_packed(Qw, Aw, sizes, conf))
        designs.update({name: (lambda run=run: run(Qw, Aw, sizes, conf))
                        for name, run in others.items()})
        for name, fn in designs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at [{B} x {R} x {W}] differs "
                                     "from the plain version")
        designs["empty launch (torch.cuda._sleep(0))"] = (
            lambda: torch.cuda._sleep(0))
        times = {name: [] for name in designs}
        order = list(designs)
        for _ in range(args.rounds):
            for name in order:
                times[name].append(device_ms(designs[name]))
            order.reverse()
        popc_s = sms * 16 * 1.98e9
        bound = {"bytes": (B * W * 4 + R * W * 4 + 8 * R + 4 * B * R)
                 / 3.35e12 * 1e3,
                 "CUDA-core popcounts": B * R * W / popc_s * 1e3}
        if found:
            bound["b1 tensor cores"] = B * R * W * 32 / found["b1"] * 1e3
        print(f"[{B} x {R} x {W} words], exact; bounds (ms) "
              + ", ".join(f"{k} {v:.5f}" for k, v in bound.items())
              + f"; ms over {args.rounds} rounds of {LAUNCHES} launches "
              "(median, fastest, slowest):")
        for name, ts in sorted(times.items(),
                               key=lambda kv: statistics.median(kv[1])):
            print(f"  {name}: {statistics.median(ts):.5f}, {min(ts):.5f}, "
                  f"{max(ts):.5f}")
        results[f"{B}x{R}"] = dict(bound_ms=bound, ms=times)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, b1_assembles=assembles,
                                            rates=found, shapes=results),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

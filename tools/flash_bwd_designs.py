"""Time the flash-attention backward kernel the port ships against other
sources with its C entry point, at the training shapes.

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as shipped and any
other source named on the command line (``NAME=PATH``, e.g. a parent
commit's ``flash_attention_bwd.cu`` written under ``build/`` first, since
a copy of the repository without ``.git`` has no history, or a copy with
other tiles; ``csrc`` is on its include path), one ``nvcc`` each, all
started together.  At each of chip_smoke's training cases
(gemma3-1b [4, 2048, 4/1, 256] at windows 512 and 0, [4, 2048, 32/8, 128]
and [4, 2048, 32/32, 64], bf16) every build is held against the plain
backward fed the plain forward's output and ``lse``, with chip_smoke's
block gate (each 64-row block within 1e-2 of its norm + 1e-5 x sqrt(n)),
and its two launches must be bit-identical; then all are timed with CUDA
events in turns (in one order, then the reverse), beside SDPA's backward
and the bound (10·B·H·hd·live flops at the bf16 peak), and each build's
kernels are timed by name from a ``torch.profiler`` trace.  Needs an
NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/flash_bwd_designs.py [--out FILE] \\
        [NAME=PATH ...]

Prints the card's name and power limit, then a line a case and build:
its gate, its two times, its time a kernel.  ``--out`` also writes them as
JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import loader
from repro_torch.kernels.flash_attention import kernel as flash

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "flash_bwd_designs"
# chip_smoke's TRAIN_BWD_CASES: (name, B, S, H, KV, hd, window)
CASES = [("gemma3-1b", 4, 2048, 4, 1, 256, 512),
         ("gemma3-1b", 4, 2048, 4, 1, 256, 0),
         ("granite-3-8b", 4, 2048, 32, 8, 128, 0),
         ("musicgen-large", 4, 2048, 32, 32, 64, 0)]
GATE = (1e-2, 1e-5)          # chip_smoke's BWD_GATE in bf16
REPS = 20
TRACE_CALLS = 5
PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM


def build(extra):
    """The shipped library and one ``nvcc`` an extra source, all started
    together: {name: library path}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(extra.items()):
        lib = OUT_DIR / f"libflash_bwd_design{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [loader._nvcc(), *loader.NVCC_FLAGS, "-I", str(loader.CSRC),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    loader.build(["flash_attention", "flash_attention_bwd"])
    built = {"shipped": loader.library_path("flash_attention_bwd")}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = lib
    return built


def launcher(lib: Path):
    dll = ctypes.CDLL(str(lib))
    fn = dll.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, out, lse, dout, window):
        B, S, H, hd = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        d = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), d.data_ptr(), B, S, H,
                 k.shape[2], hd, window, 1.0 / math.sqrt(hd), 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name}: CUDA error {err}")
        return dq, dk, dv
    return run


def block_err(got, want, rows=64):
    """The largest ||got - want|| / (rtol·||want|| + atol·√n) over blocks
    of ``rows`` sequence rows of each batch row and head."""
    rtol, atol = GATE
    B, S, Hh, hd = want.shape
    n = -(-S // rows)
    x = want.float().new_zeros((2, B, n * rows, Hh, hd))
    x[0, :, :S] = got.float() - want.float()
    x[1, :, :S] = want.float()
    d, w = x.reshape(2, B, n, rows, Hh, hd).square().sum((3, 5)).sqrt()
    return float((d / (rtol * w + atol * (rows * hd) ** 0.5)).max())


def device_ms(fn) -> float:
    """Mean device time of ``fn`` over REPS calls queued behind a spin of
    the card, so that they run back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def kernel_ms(fn) -> dict:
    """Device time a call by kernel name, from a ``torch.profiler`` trace
    of TRACE_CALLS calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_CALLS):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + float(e["dur"]) / 1e3 / TRACE_CALLS
    return out


def live_pairs(S: int, window: int) -> int:
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="write the results as JSON")
    ap.add_argument("extra", nargs="*", metavar="NAME=PATH",
                    help="another source with flash_attention_bwd.cu's C "
                         "entry point")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    extra = {}
    for spec in args.extra:
        name, _, path = spec.partition("=")
        extra[name] = Path(path).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    runs = {name: launcher(lib) for name, lib in build(extra).items()}
    print(f"built {len(runs)} libraries in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for model, B, S, H, KV, hd, w in CASES:
        q, k, v, g = (torch.randn(s, generator=gen, device="cuda").to(
            torch.bfloat16) for s in ((B, S, H, hd), (B, S, KV, hd),
                                      (B, S, KV, hd), (B, S, H, hd)))
        out, lse = flash.flash_attention_fwd(q, k, v, window=w,
                                             return_lse=True)
        want = flash.flash_attention_bwd_plain(
            q, k, v, flash.flash_attention_plain(q, k, v, window=w),
            flash.flash_attention_lse_plain(q, k, window=w), g, window=w)
        gates = {}
        for name, run in runs.items():
            got, again = (run(q, k, v, out, lse, g, w) for _ in range(2))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
            gates[name] = [block_err(a, b) for a, b in zip(got, want)]
            if max(gates[name]) > 1:
                raise AssertionError(f"{name} at {model} window {w}: "
                                     f"gate {gates[name]}")
        del want
        times = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                times[name].append(device_ms(
                    lambda: runs[name](q, k, v, out, lse, g, w)))
        by_kernel = {name: kernel_ms(
            lambda: runs[name](q, k, v, out, lse, g, w)) for name in runs}
        held = [x.transpose(1, 2).contiguous().requires_grad_(True)
                for x in (q, k, v)]
        if w:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            o_s = F.scaled_dot_product_attention(*held, attn_mask=mask,
                                                 enable_gqa=True)
        else:
            o_s = F.scaled_dot_product_attention(*held, is_causal=True,
                                                 enable_gqa=True)
        g_s = g.transpose(1, 2).contiguous()
        sdpa = device_ms(lambda: torch.autograd.grad(o_s, held, g_s,
                                                     retain_graph=True))
        bound = 10 * B * H * hd * live_pairs(S, w) / PEAK_FLOPS * 1e3
        label = f"{model} [{B}, {S}, {H}/{KV}, {hd}] window {w}"
        print(f"{label}: bound {bound:.4f} ms, SDPA backward {sdpa:.4f} ms")
        for name in runs:
            kern = ", ".join(f"{n} {t:.4f}" for n, t in
                             by_kernel[name].items())
            print(f"  {name}: gate {max(gates[name]):.3g}, "
                  + " / ".join(f"{t:.4f}" for t in times[name])
                  + f" ms ({min(times[name]) / sdpa:.2f}x SDPA, "
                  f"{min(times[name]) / bound:.1f}x bound); by kernel: "
                  f"{kern}")
            rows.append(dict(case=label, design=name, gate=gates[name],
                             ms=times[name], by_kernel_ms=by_kernel[name],
                             sdpa_ms=sdpa, bound_ms=bound))
        del held, o_s, g_s, q, k, v, g, out, lse
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

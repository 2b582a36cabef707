"""Selective scan: the wrappers of the hand-written Hopper kernels
``csrc/selective_scan.cu`` (forward) and ``csrc/selective_scan_bwd.cu``
(backward).

The forward replaces the reference's ``selective_scan_pallas``
(``repro/kernels/selective_scan/kernel.py``).  The recurrence
``h_t = a_t ⊙ h_{t-1} + b_t`` has B·D·N independent lanes; the kernel
gives each lane one thread that holds ``h`` in a register and walks T in
order, and the N lanes of one channel meet in warp shuffles for
``y_t = C_t · h_t``.  On H100 it is bound by bytes: a and b are read once,
2·B·T·D·N·4 bytes for four flops per element.  Under training it also
stores the state entering every chunk of ``CHUNK`` steps.

The backward replaces no TPU kernel (the reference differentiates its
``lax.scan``).  Each lane walks the chunks back, recomputing a chunk's h
in registers from its checkpoint, so a and b are read once and da and db
written once; dC's sum over channels goes through per-block partial sums
and a second launch that adds them in a fixed order.  See the sources for
the designs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)

STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N must divide a warp's 32 lanes
MAX_GRID_Y = 65_535                    # blocks along the batch
CHUNK = 16                 # steps between checkpoints (csrc kScanChunk)
BWD_LAUNCHES_PER_CALL = 2  # the walk back, then dC's sum over blocks

# the kernels' functions as plain tensor ops: the oracles' arithmetic
selective_scan_plain = selective_scan_ref
selective_scan_bwd_plain = selective_scan_bwd_ref


def n_chunks(T: int) -> int:
    """Checkpoints the forward stores for T steps: one a ``CHUNK``."""
    return -(-T // CHUNK)


def selective_scan_checkpoints_plain(a, b, C, h0):
    """:func:`selective_scan_plain`'s ``(y, h_last)`` (the same operations,
    so the same bits) and the state entering each chunk of ``CHUNK``
    steps, [B, n_chunks(T), D, N]: what the kernel returns under
    ``checkpoints=True``."""
    B, T, D, N = a.shape
    h, ys, hck = h0, [], []
    for t in range(T):
        if t % CHUNK == 0:
            hck.append(h)
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else a.new_zeros((B, 0, D))
    hck = torch.stack(hck, dim=1) if hck else a.new_zeros((B, 0, D, N))
    return y, h, hck


@functools.cache
def _launcher():
    lib = loader.load("selective_scan")
    fn = lib.selective_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_launcher():
    lib = loader.load("selective_scan_bwd")
    fn = lib.selective_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.selective_scan_bwd_workspace.argtypes = [ctypes.c_int] * 4
    lib.selective_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib, fn


def _check_inputs(a, b, C, h0, **more):
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"want a and b of one [B, T, D, N] shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, T, D, N = a.shape
    if tuple(C.shape) != (B, T, N):
        raise ValueError(f"C {tuple(C.shape)} is not [B, T, N] = "
                         f"{(B, T, N)}")
    if tuple(h0.shape) != (B, D, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not [B, D, N] = "
                         f"{(B, D, N)}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} does not divide 32 "
                         f"{STATE_SIZES}")
    shapes = {"dy": (B, T, D), "dh_last": (B, D, N),
              "checkpoints": (B, n_chunks(T), D, N)}
    for name, x in more.items():
        if x is not None and tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(x.shape)} is not "
                             f"{shapes[name]}")
    named = (("a", a), ("b", b), ("C", C), ("h0", h0), *more.items())
    for name, x in named:
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")


def _check_card(B, D, N, named) -> None:
    """What the kernels' grids and 32-bit lane index take, and contiguous
    inputs."""
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_GRID_Y}")
    if D * N >= 2**31:
        # the kernels' lane index within a batch row is a 32-bit int
        raise ValueError(f"D*N = {D * N} lanes exceed a 32-bit index")
    for name, x in named:
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def selective_scan_fwd(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                       h0: torch.Tensor, *, checkpoints: bool = False):
    """(y [B, T, D], h_last [B, D, N]) of the scan ``h_t = a_t ⊙ h_{t-1} +
    b_t``, ``y_t = Σ_n C_t[n]·h_t[:, n]`` from ``h0``, all float32.  A CUDA
    tensor goes through the kernel (contiguous inputs), a CPU tensor
    through the plain version.  With ``checkpoints=True`` it also returns
    the state entering each chunk of ``CHUNK`` steps, [B, n_chunks(T), D,
    N], which :func:`selective_scan_bwd` walks back from (the same launch,
    writing 1/CHUNK of a pass more).
    """
    _check_inputs(a, b, C, h0)
    if a.device.type == "cpu":
        if checkpoints:
            return selective_scan_checkpoints_plain(a, b, C, h0)
        return selective_scan_plain(a, b, C, h0)
    if a.device.type != "cuda":
        raise ValueError(f"no selective_scan kernel for {a.device}")
    B, T, D, N = a.shape
    _check_card(B, D, N, (("a", a), ("b", b), ("C", C), ("h0", h0)))
    y = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=a.device)
    hck = (torch.empty((B, n_chunks(T), D, N), dtype=torch.float32,
                       device=a.device) if checkpoints else None)
    out = (y, h_last, hck) if checkpoints else (y, h_last)
    if h0.numel() == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), C.data_ptr(), h0.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(),
                 hck.data_ptr() if checkpoints else None, B, T, D, N, stream)
    loader.check(lib, err, "selective_scan launch")
    selective_scan_fwd.launches += 1
    return out


def selective_scan_bwd(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                       h0: torch.Tensor, dy: torch.Tensor,
                       dh_last: torch.Tensor | None = None, *,
                       checkpoints: torch.Tensor | None = None):
    """(da, db [B, T, D, N], dC [B, T, N], dh0 [B, D, N]): the gradient of
    :func:`selective_scan_fwd`'s function at ``(a, b, C, h0)`` given ``dy``
    [B, T, D] and ``dh_last`` [B, D, N] (zeros when None), all float32.

    A CUDA tensor goes through the backward kernel, which walks back from
    the forward's ``checkpoints`` (``selective_scan_fwd(...,
    checkpoints=True)``'s third output, required there): one call is
    ``BWD_LAUNCHES_PER_CALL`` launches, each counted in
    ``selective_scan_bwd.launches``.  A CPU tensor goes through the plain
    version, which recomputes h from ``h0`` and reads no checkpoints.
    """
    _check_inputs(a, b, C, h0, dy=dy, dh_last=dh_last,
                  checkpoints=checkpoints)
    if a.device.type == "cpu":
        return selective_scan_bwd_plain(a, b, C, h0, dy, dh_last)
    if a.device.type != "cuda":
        raise ValueError(f"no selective_scan_bwd kernel for {a.device}")
    if checkpoints is None:
        raise ValueError("the backward kernel walks back from the forward's "
                         "checkpoints: pass selective_scan_fwd(..., "
                         "checkpoints=True)'s third output")
    B, T, D, N = a.shape
    _check_card(B, D, N, (("a", a), ("b", b), ("C", C), ("h0", h0),
                          ("dy", dy), ("dh_last", dh_last),
                          ("checkpoints", checkpoints)))
    f32, dev = torch.float32, a.device
    da, db = torch.empty_like(a), torch.empty_like(a)
    if T == 0 or h0.numel() == 0:
        # nothing to walk: dC sums over no step or no channel
        dh0 = torch.zeros_like(h0) if dh_last is None else dh_last.clone()
        return da, db, torch.zeros((B, T, N), dtype=f32, device=dev), dh0
    dC = torch.empty((B, T, N), dtype=f32, device=dev)
    dh0 = torch.empty_like(h0)
    lib, fn = _bwd_launcher()
    part = torch.empty((lib.selective_scan_bwd_workspace(B, T, D, N),),
                       dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), C.data_ptr(),
                 checkpoints.data_ptr(), dy.data_ptr(),
                 None if dh_last is None else dh_last.data_ptr(),
                 da.data_ptr(), db.data_ptr(), dC.data_ptr(), dh0.data_ptr(),
                 part.data_ptr(), B, T, D, N, stream)
    loader.check(lib, err, "selective_scan_bwd launch")
    selective_scan_bwd.launches += BWD_LAUNCHES_PER_CALL
    return da, db, dC, dh0


def zero_launches() -> None:
    """Set the forward's and the backward's counts of launches to 0."""
    selective_scan_fwd.launches = 0
    selective_scan_bwd.launches = 0


zero_launches()

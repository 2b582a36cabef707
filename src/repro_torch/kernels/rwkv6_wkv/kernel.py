"""RWKV-6 WKV recurrence: the wrappers of the hand-written Hopper kernels
``csrc/wkv6.cu`` (forward) and ``csrc/wkv6_bwd.cu`` (backward).

Replaces the reference's ``wkv6_pallas``
(``repro/kernels/rwkv6_wkv/kernel.py:87``).  Column m of the [n, n] state,
``S[:, m]``, evolves on its own: its update needs ``r_t``, ``k_t`` and
``w_t`` (indexed by the row i), ``u`` and the one value ``v_t[m]``.  So
the kernel gives each (b, h) one block that keeps S in registers for the
whole of T, each thread a tile of 8 rows × 4 columns (n²/32 threads), so
that each value of r, k and w read from shared memory serves 4 columns.
One thread loads 16 steps of r, k, v and w at a time by TMA into a ring
of 3 stages; the row groups' partial sums of y meet in shared memory once
a stage, and the u term, ``v_t[m]·Σ_i r_t[i]·u[i]·k_t[i]``, is summed
once a step for the block.  On H100 the function is bound by bytes
(5·n·4 a step and head, against 5·n² + 5·n float32 operations): 0.203 ms
at rwkv6-7b's prefill shape, where the kernel takes 0.396–0.398 ms
(chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W).  See the source for the
design.

Under training the forward also stores the state entering every chunk of
``CHUNK`` steps.  The backward replaces no TPU kernel (the reference
differentiates its ``lax.scan``): the rows of each (b, h)'s dS are split
over a thread-block cluster (2 CTAs of 8 warps at n = 64, 2 CTAs an SM),
each lane keeping 8 columns of one row in registers; a CTA takes the
chunks in reverse order, recomputes its rows of a chunk's states from the
checkpoint into registers and walks the chunk back, two steps at a time,
with no barrier a step: dr, dk and dw are summed over a row's lanes and
dv over a warp's rows by xor shuffles, and dv's sum over the warps and
ranks is sent by ``st.async`` to the rank that owns the columns and added
once a chunk.  The inputs arrive by bulk copies multicast to the cluster.
du's sum over b goes through per-(b, h) sums and a second launch that adds
them in a fixed order.  :func:`bwd_occupancy` reports the walk's
registers, shared memory, cluster and CTAs an SM on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_bwd_ref, wkv6_ref

HEAD_SIZES = (8, 16, 32, 64)      # n, the kernels' template sizes
CHUNK = 8                  # steps between checkpoints (csrc kWkvChunk)
BWD_LAUNCHES_PER_CALL = 2  # the walk back, then du's sum over b

# the kernels' functions as plain tensor ops: the oracles' arithmetic
wkv6_plain = wkv6_ref
wkv6_bwd_plain = wkv6_bwd_ref


def n_chunks(T: int) -> int:
    """Checkpoints the forward stores for T steps: one a ``CHUNK``."""
    return -(-T // CHUNK)


def wkv6_checkpoints_plain(r, k, v, w, u, s0):
    """:func:`wkv6_plain`'s ``(y, S_final)`` (the same operations, so the
    same bits, in the inputs' type) and the state entering each chunk of
    ``CHUNK`` steps, [B, H, n_chunks(T), n, n]: what the kernel returns
    under ``checkpoints=True``."""
    B, T, H, n = r.shape
    s, ys, ck = s0, [], []
    uu = u[None, :, :, None]
    for t in range(T):
        if t % CHUNK == 0:
            ck.append(s)
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else r.new_zeros((B, 0, H, n))
    ck = (torch.stack(ck, dim=2) if ck
          else r.new_zeros((B, H, 0, n, n)))
    return y, s, ck


@functools.cache
def _launcher():
    lib = loader.load("wkv6")
    fn = lib.wkv6_launch_checkpoints
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_launcher():
    lib = loader.load("wkv6_bwd")
    fn = lib.wkv6_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wkv6_bwd_occupancy.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.wkv6_bwd_occupancy.restype = ctypes.c_int
    return lib, fn


# what wkv6_bwd_occupancy writes, in its order
OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                  "threads", "cluster", "ctas_per_sm", "active_clusters")


def bwd_occupancy(n: int = 64) -> dict:
    """The backward walk's occupancy on the current card at head size
    ``n``: registers a thread (``cudaFuncGetAttributes``), static and
    dynamic shared memory a CTA in bytes, threads a CTA, CTAs a cluster,
    CTAs an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
    clusters resident on the whole card at once
    (``cudaOccupancyMaxActiveClusters``), with ``warps_per_sm``.  Needs a
    card."""
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} is not one of the kernel's "
                         f"{HEAD_SIZES}")
    lib, _ = _bwd_launcher()
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    loader.check(lib, lib.wkv6_bwd_occupancy(n, out), "wkv6_bwd occupancy")
    occ = dict(zip(OCCUPANCY_KEYS, out))
    occ["warps_per_sm"] = occ["ctas_per_sm"] * occ["threads"] // 32
    return occ


def _check_inputs(r, k, v, w, u, s0, **more):
    if r.dim() != 4:
        raise ValueError(f"want r of shape [B, T, H, n], got "
                         f"{tuple(r.shape)}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} is not r's "
                             f"{tuple(r.shape)}")
    B, T, H, n = r.shape
    if tuple(u.shape) != (H, n):
        raise ValueError(f"u {tuple(u.shape)} is not [H, n] = {(H, n)}")
    if tuple(s0.shape) != (B, H, n, n):
        raise ValueError(f"s0 {tuple(s0.shape)} is not [B, H, n, n] = "
                         f"{(B, H, n, n)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} is not one of the kernel's "
                         f"{HEAD_SIZES}")
    shapes = {"dy": (B, T, H, n), "dS_T": (B, H, n, n),
              "checkpoints": (B, H, n_chunks(T), n, n)}
    for name, x in more.items():
        if x is not None and tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(x.shape)} is not "
                             f"{shapes[name]}")
    for name, x in _named(r, k, v, w, u, s0, **more):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")


def _named(r, k, v, w, u, s0, **more):
    """(name, tensor) of every given input."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0),
             *more.items())
    return [(name, x) for name, x in named if x is not None]


def _check_card(named) -> None:
    """Contiguous inputs, all but u 16-byte aligned."""
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "u" and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "read it by TMA, cp.async or as float4)")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
             checkpoints: bool = False):
    """(y [B, T, H, n], S_final [B, H, n, n]) of the recurrence
    ``y_t = r_t·(S_{t-1} + diag(u)·k_tᵀv_t)``, ``S_t = diag(w_t)·S_{t-1} +
    k_tᵀv_t`` from ``s0``, all float32.  A CUDA tensor goes through the
    kernel (contiguous inputs; all but u 16-byte aligned), a CPU tensor
    through the plain version.  With ``checkpoints=True`` it also returns
    the state entering each chunk of ``CHUNK`` steps, [B, H, n_chunks(T),
    n, n], which :func:`wkv6_bwd` walks back from (the same launch, each
    counted in ``wkv6_fwd.checkpoint_launches`` too).
    """
    _check_inputs(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        if checkpoints:
            return wkv6_checkpoints_plain(r, k, v, w, u, s0)
        return wkv6_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for {r.device}")
    _check_card(_named(r, k, v, w, u, s0))
    B, T, H, n = r.shape
    y = torch.empty((B, T, H, n), dtype=torch.float32, device=r.device)
    s_final = torch.empty((B, H, n, n), dtype=torch.float32,
                          device=r.device)
    ck = (torch.empty((B, H, n_chunks(T), n, n), dtype=torch.float32,
                      device=r.device) if checkpoints else None)
    out = (y, s_final, ck) if checkpoints else (y, s_final)
    if s0.numel() == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                 s_final.data_ptr(), ck.data_ptr() if checkpoints else None,
                 B, T, H, n, stream)
    loader.check(lib, err, "wkv6 launch")
    wkv6_fwd.launches += 1
    wkv6_fwd.checkpoint_launches += checkpoints
    return out


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
             dy: torch.Tensor, dS_T: torch.Tensor | None = None, *,
             checkpoints: torch.Tensor | None = None):
    """(dr, dk, dv, dw [B, T, H, n], du [H, n], ds0 [B, H, n, n]): the
    gradient of :func:`wkv6_fwd`'s function at ``(r, k, v, w, u, s0)``
    given ``dy`` [B, T, H, n] and ``dS_T`` [B, H, n, n] (zeros when None),
    all float32.

    A CUDA tensor goes through the backward kernel, which walks back from
    the forward's ``checkpoints`` (``wkv6_fwd(..., checkpoints=True)``'s
    third output, required there): one call is ``BWD_LAUNCHES_PER_CALL``
    launches, each counted in ``wkv6_bwd.launches``.  A CPU tensor goes
    through the plain version, which recomputes the states from ``s0``
    and reads no checkpoints.
    """
    _check_inputs(r, k, v, w, u, s0, dy=dy, dS_T=dS_T,
                  checkpoints=checkpoints)
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, s0, dy, dS_T)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6_bwd kernel for {r.device}")
    if checkpoints is None:
        raise ValueError("the backward kernel walks back from the forward's "
                         "checkpoints: pass wkv6_fwd(..., "
                         "checkpoints=True)'s third output")
    _check_card(_named(r, k, v, w, u, s0, dy=dy, dS_T=dS_T,
                       checkpoints=checkpoints))
    B, T, H, n = r.shape
    dev = r.device
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((H, n), dtype=torch.float32, device=dev)
    ds0 = torch.empty_like(s0)
    if s0.numel() == 0:
        # no (b, h) to walk: du sums over no batch row
        return dr, dk, dv, dw, du.zero_(), ds0
    du_part = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    lib, fn = _bwd_launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 dy.data_ptr(), u.data_ptr(), checkpoints.data_ptr(),
                 None if dS_T is None else dS_T.data_ptr(), dr.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), ds0.data_ptr(),
                 du.data_ptr(), du_part.data_ptr(), B, T, H, n, stream)
    loader.check(lib, err, "wkv6_bwd launch")
    wkv6_bwd.launches += BWD_LAUNCHES_PER_CALL
    return dr, dk, dv, dw, du, ds0


def zero_launches() -> None:
    """Set the forward's and the backward's counts of launches to 0."""
    wkv6_fwd.launches = 0
    wkv6_fwd.checkpoint_launches = 0
    wkv6_bwd.launches = 0


zero_launches()

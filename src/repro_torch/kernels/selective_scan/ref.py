"""Plain PyTorch oracles for the selective scan, in float32: the
reference's ``selective_scan_ref`` op for op (one step of the recurrence
at a time), its gradient (the reference differentiates its ``lax.scan``
with ``jax.value_and_grad``), and the gate that holds a backward kernel
against that gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import bwd_block_err


def selective_scan_ref(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                       h0: torch.Tensor | None = None):
    """h_t = a_t ⊙ h_{t-1} + b_t ;  y_t = Σ_n C_t[n]·h_t[:, n]

    a, b: [B, T, D, N] (a ∈ (0, 1]); C: [B, T, N]; h0: [B, D, N].
    Returns (y [B, T, D], h_last [B, D, N]), float32.
    """
    B, T, D, N = a.shape
    f32 = torch.float32
    h = (torch.zeros((B, D, N), dtype=f32, device=a.device) if h0 is None
         else h0.to(f32))
    a, b, C = a.to(f32), b.to(f32), C.to(f32)
    ys = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, D), dtype=f32, device=a.device))
    return y, h


def selective_scan_bwd_ref(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                           h0: torch.Tensor | None, dy: torch.Tensor,
                           dh_last: torch.Tensor | None = None):
    """The gradient of :func:`selective_scan_ref`'s ``(y, h_last)`` at
    ``(a, b, C, h0)``, given ``dy`` [B, T, D] and ``dh_last`` [B, D, N]
    (zeros when None).  Returns (da, db [B, T, D, N], dC [B, T, N], dh0
    [B, D, N]), float32 (float64 where ``a`` is, for ``gradcheck``).

    The reverse scan ``g_t = a_{t+1} ⊙ g_{t+1} + dy_t[:, None]·C_t[None,
    :]`` from ``g_{T-1} = dy_{T-1}·C_{T-1} + dh_last``; then ``da_t = g_t ⊙
    h_{t-1}`` (``h_{-1} = h0``), ``db_t = g_t``, ``dC_t[n] = Σ_d dy_t[d]·
    h_t[d, n]`` and ``dh0 = a_0 ⊙ g_0``.  At T = 0, da, db and dC are empty
    and dh0 is dh_last.
    """
    B, T, D, N = a.shape
    f32 = torch.promote_types(a.dtype, torch.float32)
    a, b, C, dy = (x.to(f32) for x in (a, b, C, dy))
    h = (torch.zeros((B, D, N), dtype=f32, device=a.device) if h0 is None
         else h0.to(f32))
    hs = [h]                                  # hs[t] = h_{t-1}
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    g = (torch.zeros((B, D, N), dtype=f32, device=a.device)
         if dh_last is None else dh_last.to(f32).clone())
    da, db = torch.empty_like(a), torch.empty_like(a)
    dC = torch.empty((B, T, N), dtype=f32, device=a.device)
    for t in reversed(range(T)):
        g = g + dy[:, t, :, None] * C[:, t, None, :]
        da[:, t] = g * hs[t]
        db[:, t] = g
        dC[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t + 1])
        g = a[:, t] * g
    return da, db, dC, g


def bwd_block_errs(got, want, rtol: float, atol: float, rows: int = 64):
    """The backward gate of the flash kernels (``bwd_block_err``) over the
    scan's four gradients: da and db in blocks of ``rows`` time steps of
    each batch row and channel, dC in blocks of ``rows`` time steps of each
    batch row, dh0 in blocks of ``rows`` channels of each batch row.  Each
    entry is at most 1 where every block is within rtol·||plain|| +
    atol·√n."""
    da, db, dC, dh0 = got
    wa, wb, wC, wh = want
    return [bwd_block_err(da, wa, rtol, atol, rows),
            bwd_block_err(db, wb, rtol, atol, rows),
            bwd_block_err(dC[:, :, None], wC[:, :, None], rtol, atol, rows),
            bwd_block_err(dh0[:, :, None], wh[:, :, None], rtol, atol, rows)]


def bwd_planted_faults(a, b, C, h0, dy, dh_last, got, want, chunk: int = 16):
    """Two faulty backward kernels' results, built from ``got`` (the
    kernel's ``(da, db, dC, dh0)``) and ``want`` (the plain version's), as
    ``{name: (da, db, dC, dh0)}``: ``"dh_last dropped"`` (only where
    ``dh_last`` is given: the kernel's result less what dh_last adds), and
    ``"h off by one step"`` (the first ``chunk`` steps' da taken at h_t in
    place of h_{t-1}, as a checkpoint read one step late gives).  The gate
    must fail each."""
    faults = {}
    if dh_last is not None:
        lost = [w - n for w, n in zip(
            want, selective_scan_bwd_ref(a, b, C, h0, dy, None))]
        faults["dh_last dropped"] = tuple(g - x for g, x in zip(got, lost))
    da = got[0].clone()
    h = h0.float()
    for t in range(min(chunk, a.shape[1])):
        h_prev, h = h, a[:, t].float() * h + b[:, t].float()
        da[:, t] += got[1][:, t] * (h - h_prev)
    faults["h off by one step"] = (da,) + tuple(got[1:])
    return faults

"""Plain PyTorch oracles for the RWKV-6 WKV recurrence, in float32: the
reference's ``wkv6_ref`` op for op (one step of the recurrence at a
time), its gradient (the reference trains rwkv by differentiating its
``lax.scan`` with ``jax.value_and_grad``), and the gate that holds a
backward kernel against that gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import bwd_block_err


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor | None = None):
    """r, k, v, w: [B, T, H, n] (w in (0, 1)); u: [H, n]; s0: [B, H, n, n].

    y_t = r_t · (S_{t-1} + diag(u)·k_tᵀv_t);  S_t = diag(w_t)·S_{t-1} + k_tᵀv_t
    Returns (y [B, T, H, n], S_final [B, H, n, n]), all float32.
    """
    B, T, H, n = r.shape
    f32 = torch.float32
    s = (torch.zeros((B, H, n, n), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    r, k, v, w = (x.to(f32) for x in (r, k, v, w))
    uu = u.to(f32)[None, :, :, None]
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, n, n]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, n), dtype=f32, device=r.device))
    return y, s


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
                 dy: torch.Tensor, dS_T: torch.Tensor | None = None):
    """The gradient of :func:`wkv6_ref`'s ``(y, S_final)`` at ``(r, k, v,
    w, u, s0)``, given ``dy`` [B, T, H, n] and ``dS_T`` [B, H, n, n]
    (zeros when None).  Returns (dr, dk, dv, dw [B, T, H, n], du [H, n],
    ds0 [B, H, n, n]), float32 (float64 where ``r`` is, for
    ``gradcheck``).

    It keeps the forward's states and walks T back, newest first, with
    ``dS`` the gradient of the state ``S_t``:

        dr_t[i] = Σ_m dy_t[m]·(S_{t-1}[i,m] + u[i]k_t[i]v_t[m])
        dk_t[i] = r_t[i]u[i](dy_t·v_t) + Σ_m dS[i,m]v_t[m]
        dv_t[m] = (Σ_i r_t[i]u[i]k_t[i])·dy_t[m] + Σ_i dS[i,m]k_t[i]
        dw_t[i] = Σ_m dS[i,m]S_{t-1}[i,m]
        du[i]  += r_t[i]k_t[i](dy_t·v_t)        (over b and t)
        dS     <- diag(w_t)·dS + r_tᵀdy_t        (dS_{t-1})

    from ``dS = dS_T``; ``ds0`` is the last ``dS``.  At T = 0 the four
    step gradients are empty, du is 0 and ds0 is dS_T.
    """
    B, T, H, n = r.shape
    f32 = torch.promote_types(r.dtype, torch.float32)
    r, k, v, w, dy = (x.to(f32) for x in (r, k, v, w, dy))
    uu = u.to(f32)
    s = (torch.zeros((B, H, n, n), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    states = [s]                              # states[t] = S_{t-1}
    for t in range(T):
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
        states.append(s)
    g = (torch.zeros((B, H, n, n), dtype=f32, device=r.device)
         if dS_T is None else dS_T.to(f32).clone())
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((H, n), dtype=f32, device=r.device)
    for t in reversed(range(T)):
        r_t, k_t, v_t, dy_t = r[:, t], k[:, t], v[:, t], dy[:, t]
        vy = (v_t * dy_t).sum(-1, keepdim=True)              # [B, H, 1]
        ruk = (r_t * uu * k_t).sum(-1, keepdim=True)
        dr[:, t] = (torch.einsum("bhim,bhm->bhi", states[t], dy_t)
                    + uu * k_t * vy)
        dk[:, t] = torch.einsum("bhim,bhm->bhi", g, v_t) + r_t * uu * vy
        dv[:, t] = ruk * dy_t + torch.einsum("bhim,bhi->bhm", g, k_t)
        dw[:, t] = (g * states[t]).sum(-1)
        du += (r_t * k_t * vy).sum(0)
        g = w[:, t, :, :, None] * g + r_t[..., :, None] * dy_t[..., None, :]
    return dr, dk, dv, dw, du, g


def bwd_block_errs(got, want, rtol: float, atol: float, rows: int = 64):
    """The backward gate of the flash kernels (``bwd_block_err``) over the
    WKV's six gradients: dr, dk, dv and dw in blocks of ``rows`` time steps
    of each (b, h), du a block a head, ds0 in blocks of ``rows`` state rows
    of each (b, h).  Each entry is at most 1 where every block is within
    rtol·||plain|| + atol·√n (0 for an empty one, at T = 0)."""
    *steps, du, ds0 = got
    *w_steps, w_du, w_ds0 = want
    pairs = [*zip(steps, w_steps), (du[None, None], w_du[None, None]),
             (ds0.transpose(1, 2), w_ds0.transpose(1, 2))]
    return [bwd_block_err(g, w, rtol, atol, rows) if w.numel() else 0.0
            for g, w in pairs]


def bwd_planted_faults(r, k, v, w, u, s0, dy, dS_T, got, want,
                       chunk: int = 8):
    """Faulty backward kernels' results, built from ``got`` (the kernel's
    ``(dr, dk, dv, dw, du, ds0)``) and ``want`` (the plain version's), as
    ``{name: (dr, dk, dv, dw, du, ds0)}``: ``"dS_T dropped"`` (only where
    ``dS_T`` is given: the kernel's result less what dS_T adds), ``"u term
    of dk dropped"`` (dk less r_t⊙u·(dy_t·v_t)), ``"S read one step
    late"`` (the first ``chunk`` steps' dr taken at S_t in place of
    S_{t-1}, as a recomputed state read one slot late gives) and ``"one row
    group's share of dv dropped"`` (dv_t less Σ_i dS_t[i, m]·k_t[i] over
    the first quarter of the rows i, as a cluster rank whose partial sums
    are missed gives; only where dS_t is not 0 at every step, that is
    where ``dS_T`` is given or T > 1).  The gate must fail each."""
    f32 = torch.float32
    faults = {}
    if dS_T is not None:
        lost = [x - y for x, y in zip(
            want, wkv6_bwd_ref(r, k, v, w, u, s0, dy, None))]
        faults["dS_T dropped"] = tuple(g - x for g, x in zip(got, lost))
    r, k, v, w, dy = (x.to(f32) for x in (r, k, v, w, dy))
    vy = (v * dy).sum(-1, keepdim=True)
    faults["u term of dk dropped"] = (
        got[0], got[1] - r * u.to(f32) * vy) + tuple(got[2:])
    dr = got[0].clone()
    s = (torch.zeros_like(got[5]) if s0 is None else s0.to(f32))
    for t in range(min(chunk, r.shape[1])):
        s_prev = s
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
        dr[:, t] += torch.einsum("bhim,bhm->bhi", s - s_prev, dy[:, t])
    faults["S read one step late"] = (dr,) + tuple(got[1:])
    B, T, H, n = r.shape
    if dS_T is not None or T > 1:
        # dS_t does not depend on k: walk it back from dS_T
        q = max(n // 4, 1)
        dv = got[2].clone()
        g = (torch.zeros((B, H, q, n), dtype=f32, device=r.device)
             if dS_T is None else dS_T.to(f32)[:, :, :q].clone())
        for t in reversed(range(T)):
            dv[:, t] -= torch.einsum("bhim,bhi->bhm", g, k[:, t, :, :q])
            g = (w[:, t, :, :q, None] * g
                 + r[:, t, :, :q, None] * dy[:, t, :, None, :])
        faults["one row group's share of dv dropped"] = (
            got[:2] + (dv,) + tuple(got[3:]))
    return faults

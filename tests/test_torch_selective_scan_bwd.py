"""The port's selective-scan backward, held against the reference.

The reference has no backward kernel: it differentiates its ``lax.scan``
with jax's autodiff.  On the CPU the backward wrapper runs its plain
PyTorch version, ``selective_scan_bwd_ref``; these tests hold it to
``jax.vjp`` of the reference's ``selective_scan_ref`` (rtol = atol = 1e-5
in float32), hold :class:`SelectiveScan`'s gradient to autograd through
the plain forward (1e-5), check it in float64 with ``gradcheck``, and hold
the model's SSM scan gradients to ``jax.vjp`` of the reference's model
scan in each ``ssm_impl``.  Inputs are drawn with numpy from a seed, at
shapes no larger than [2, 64, 32, 8].  The CUDA kernel is compared with
the same plain version on the card (``tests/test_torch_train_card.py``,
``chip_smoke.py`` phase 16g).
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref as jnp_selective_scan_ref)
from repro.models.ssm import _selective_scan as jnp_model_scan  # noqa: E402
from repro_torch.kernels.selective_scan import kernel, ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_bwd_ref, selective_scan_ref)
from repro_torch.models import ssm  # noqa: E402

TOL = 1e-5             # float32, relative and absolute
MODEL_TOL = 1e-4       # the model scan's gradients: each over its max

# (B, T, D, N): one step, T across the 16-step chunk, every state size
SHAPES = [(1, 1, 8, 4), (2, 17, 12, 8), (2, 64, 32, 8), (1, 37, 24, 1),
          (2, 20, 8, 32), (1, 33, 16, 2)]


def _inputs(B, T, D, N, seed):
    """a ∈ (0.5, 1), b, C, a nonzero h0, dy and dh_last, float32 numpy."""
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(0.5, 1.0, (B, T, D, N)),
              rng.standard_normal((B, T, D, N)) * 0.3,
              rng.standard_normal((B, T, N)),
              rng.standard_normal((B, D, N)) * 0.2,
              rng.standard_normal((B, T, D)),
              rng.standard_normal((B, D, N))]
    return [x.astype(np.float32) for x in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("B,T,D,N", SHAPES)
def test_plain_backward_matches_jax_vjp(B, T, D, N, with_dh):
    a, b, C, h0, dy, dh = _inputs(B, T, D, N, B + T + D + N)
    want = jax.jit(lambda xs, ct: jax.vjp(jnp_selective_scan_ref, *xs)[1](
        ct))([jnp.asarray(x) for x in (a, b, C, h0)],
             (jnp.asarray(dy),
              jnp.asarray(dh if with_dh else np.zeros_like(dh))))
    launches = kernel.selective_scan_bwd.launches
    got = kernel.selective_scan_bwd(
        *(torch.from_numpy(x) for x in (a, b, C, h0, dy)),
        torch.from_numpy(dh) if with_dh else None)
    assert kernel.selective_scan_bwd.launches == launches     # CPU: plain
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("B,T,D,N", SHAPES)
def test_function_gradient_matches_autograd_of_the_plain_forward(B, T, D,
                                                                 N):
    arrays = _inputs(B, T, D, N, 7 * T + N)
    dy, dh = (torch.from_numpy(x) for x in arrays[4:])
    held = [torch.from_numpy(x).requires_grad_(True) for x in arrays[:4]]
    y, h_last = ops.selective_scan(*held)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    got = torch.autograd.grad((y, h_last), held, (dy, dh))
    plain = [torch.from_numpy(x).requires_grad_(True) for x in arrays[:4]]
    y_p, h_p = selective_scan_ref(*plain)
    _close(y.detach(), y_p.detach(), 0)
    want = torch.autograd.grad((y_p, h_p), plain, (dy, dh))
    for g, w in zip(got, want):
        _close(g, w)


def test_function_gradient_carries_the_casts():
    """bf16 inputs: the casts to float32 sit outside the Function, so each
    input's gradient comes back in its own type."""
    a, b, C, h0, dy, _ = _inputs(1, 9, 8, 4, 2)
    held = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
            for x in (a, b, C)]
    y, _ = ops.selective_scan(*held)
    grads = torch.autograd.grad(y, held, torch.from_numpy(dy))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    want = selective_scan_bwd_ref(*(x.detach().float() for x in held), None,
                                  torch.from_numpy(dy))
    for g, w in zip(grads, want):
        _close(g.float(), w.to(torch.bfloat16).float())


class _Plain(torch.autograd.Function):
    """The arithmetic of :class:`ops.SelectiveScan` with the plain forward
    and backward, in the inputs' type (``gradcheck`` wants float64; the
    kernels' wrappers take float32 only)."""

    @staticmethod
    def forward(ctx, a, b, C, h0):
        ctx.save_for_backward(a, b, C, h0)
        y, h_last, _ = kernel.selective_scan_checkpoints_plain(a, b, C, h0)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        return kernel.selective_scan_bwd_plain(*ctx.saved_tensors, dy,
                                               dh_last)


@pytest.mark.parametrize("T", [1, 5])
def test_plain_backward_passes_gradcheck_in_float64(T):
    rng = np.random.default_rng(T)
    B, D, N = 1, 3, 2
    held = [torch.from_numpy(x).requires_grad_(True) for x in (
        rng.uniform(0.5, 1.0, (B, T, D, N)), rng.standard_normal((B, T, D, N)),
        rng.standard_normal((B, T, N)), rng.standard_normal((B, D, N)))]
    assert torch.autograd.gradcheck(_Plain.apply, held)


@pytest.mark.parametrize("T", [0, 1, 16, 17, 37])
def test_checkpoints_are_the_states_entering_each_chunk(T):
    a, b, C, h0, _, _ = (torch.from_numpy(x)
                         for x in _inputs(2, T, 8, 4, T))
    y, h_last, hck = kernel.selective_scan_fwd(a, b, C, h0,
                                               checkpoints=True)
    y_p, h_p = kernel.selective_scan_fwd(a, b, C, h0)
    assert torch.equal(y, y_p) and torch.equal(h_last, h_p)
    assert hck.shape == (2, kernel.n_chunks(T), 8, 4)
    for c in range(kernel.n_chunks(T)):
        t = c * kernel.CHUNK
        _, want = selective_scan_ref(a[:, :t], b[:, :t], C[:, :t], h0)
        assert torch.equal(hck[:, c], want)


def test_backward_at_no_steps():
    a, b, C, h0, dy, dh = (torch.from_numpy(x)
                           for x in _inputs(2, 0, 8, 4, 0))
    da, db, dC, dh0 = kernel.selective_scan_bwd(a, b, C, h0, dy, dh)
    assert da.shape == db.shape == (2, 0, 8, 4) and dC.shape == (2, 0, 4)
    assert torch.equal(dh0, dh)
    assert torch.equal(kernel.selective_scan_bwd(a, b, C, h0, dy)[3],
                       torch.zeros_like(h0))


def _bad_backward_inputs():
    a, b, C, h0, dy, dh = (torch.from_numpy(x)
                           for x in _inputs(1, 8, 4, 16, 1))
    ck = torch.zeros((1, 1, 4, 16))
    return [
        ("dy of another width", (a, b, C, h0, dy[..., :2], dh, ck),
         ValueError),
        ("dh_last of another width", (a, b, C, h0, dy, dh[:, :2], ck),
         ValueError),
        ("checkpoints of another count", (a, b, C, h0, dy, dh,
                                          torch.zeros((1, 2, 4, 16))),
         ValueError),
        ("float64 dy", (a, b, C, h0, dy.double(), dh, ck), TypeError),
        ("bf16 dh_last", (a, b, C, h0, dy, dh.bfloat16(), ck), TypeError),
        ("meta device", tuple(x.to("meta") for x in (a, b, C, h0, dy, dh,
                                                     ck)), ValueError),
        ("dy on another device", (a, b, C, h0, dy.to("meta"), dh, ck),
         ValueError),
    ]


@pytest.mark.parametrize("case", _bad_backward_inputs(), ids=lambda c: c[0])
def test_backward_wrapper_refuses_bad_inputs(case):
    _, (a, b, C, h0, dy, dh, ck), err = case
    launches = kernel.selective_scan_bwd.launches
    with pytest.raises(err):
        kernel.selective_scan_bwd(a, b, C, h0, dy, dh, checkpoints=ck)
    assert kernel.selective_scan_bwd.launches == launches


def test_serving_path_takes_no_checkpoints():
    """Under no_grad, or with no input that requires grad, the entry is one
    forward call without checkpoints; while autograd records, one with."""
    a, b, C, h0, _, _ = (torch.from_numpy(x) for x in _inputs(1, 9, 8, 4, 3))
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("checkpoints", False))
        return kernel.selective_scan_fwd(*args, **kw)

    held = a.clone().requires_grad_(True)
    with mock.patch.object(ops, "selective_scan_fwd", spy):
        ops.selective_scan(a, b, C, h0)
        with torch.no_grad():
            y, _ = ops.selective_scan(held, b, C, h0)
        assert y.grad_fn is None
        y, _ = ops.selective_scan(held, b, C, h0)
    assert calls == [False, False, True]
    assert y.grad_fn is not None


@pytest.mark.parametrize("impl", ssm.SSM_IMPLS)
def test_model_scan_gradients_match_reference(impl):
    """The port's model scan (a = exp(dt·A), b = dt·B·u, the scan, + D·u)
    differentiated by autograd through the Function, against ``jax.vjp``
    of the reference's model scan in each impl, at
    tests/test_kernels.py:153's sizes: each gradient's max |difference|
    within 1e-4 of its max |value|."""
    rng = np.random.default_rng(12)
    B, S, di, N = 1, 64, 32, 8
    arrays = [x.astype(np.float32) for x in (
        rng.standard_normal((B, S, di)) * 0.5,
        np.abs(rng.standard_normal((B, S, di))) * 0.2 + 0.01,
        -(np.abs(rng.standard_normal((di, N))) + 0.1),
        rng.standard_normal((B, S, N)),
        rng.standard_normal((B, S, N)),
        rng.standard_normal(di))]
    dy = rng.standard_normal((B, S, di)).astype(np.float32)
    dh = rng.standard_normal((B, di, N)).astype(np.float32)
    want = jax.jit(lambda xs, ct: jax.vjp(
        lambda *x: jnp_model_scan(*x, impl=impl), *xs)[1](ct))(
            [jnp.asarray(x) for x in arrays], (jnp.asarray(dy),
                                               jnp.asarray(dh)))
    held = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    y, h = ssm._selective_scan(*held, impl=impl)
    got = torch.autograd.grad((y, h), held, (torch.from_numpy(dy),
                                             torch.from_numpy(dh)))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= MODEL_TOL * float(np.abs(w).max()), (g.shape, err)

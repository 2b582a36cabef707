"""The port's selective scan, held against the reference.

On the CPU the wrapper runs its plain PyTorch version.  These tests hold it
to the reference's Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) and to the reference's sequential
oracle ``selective_scan_ref``, on the same numpy-seeded inputs, at the
tolerances of ``tests/test_kernels.py``: ``atol`` 1e-4 at its four shapes,
1e-3 under extreme decay, 2e-4 on the model's dt/A/B/u decomposition.
The CUDA kernel itself is compared with the same plain version on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ops import (  # noqa: E402
    selective_scan as jnp_selective_scan)
from repro.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref as jnp_selective_scan_ref)
from repro.models.ssm import (  # noqa: E402
    _selective_scan as jnp_model_scan)
from repro_torch.kernels.selective_scan import kernel, ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref)
from repro_torch.models import ssm  # noqa: E402

ATOL = 1e-4            # tests/test_kernels.py:150
DECAY_ATOL = 1e-3      # tests/test_kernels.py:185
MODEL_ATOL = 2e-4      # tests/test_kernels.py:170

# (B, T, D, N, chunk, d_blk): tests/test_kernels.py:136-139
SHAPES = [(1, 64, 64, 16, 16, 64), (2, 128, 128, 16, 32, 64),
          (1, 48, 32, 8, 16, 32), (1, 64, 64, 4, 64, 16)]


def _scan_inputs(B, T, D, N, seed):
    """a ∈ (0, 1], b, C and h0 as in tests/test_kernels.py, as numpy."""
    rng = np.random.default_rng(seed)
    a = np.exp(-np.exp(rng.standard_normal((B, T, D, N)) * 0.5 - 1))
    b = rng.standard_normal((B, T, D, N)) * 0.3
    C = rng.standard_normal((B, T, N))
    h0 = rng.standard_normal((B, D, N)) * 0.2
    return [x.astype(np.float32) for x in (a, b, C, h0)]


def _both(arrays):
    return ([jnp.asarray(x) for x in arrays],
            [torch.from_numpy(x) for x in arrays])


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("B,T,D,N,c,dk", SHAPES)
def test_plain_version_matches_reference(B, T, D, N, c, dk):
    (ja, jb, jC, jh0), (a, b, C, h0) = _both(_scan_inputs(B, T, D, N,
                                                          T + D))
    launches = kernel.selective_scan_fwd.launches
    y, hf = ops.selective_scan(a, b, C, h0)
    assert kernel.selective_scan_fwd.launches == launches     # CPU: plain
    assert y.shape == (B, T, D) and hf.shape == (B, D, N)
    assert y.dtype == hf.dtype == torch.float32
    for want_y, want_h in (jnp_selective_scan(ja, jb, jC, jh0, chunk=c,
                                              d_blk=dk),
                           jnp_selective_scan_ref(ja, jb, jC, jh0)):
        _close(y, want_y, ATOL)
        _close(hf, want_h, ATOL)
    want_y, want_h = selective_scan_ref(a, b, C, h0)
    np.testing.assert_array_equal(y.numpy(), want_y.numpy())
    np.testing.assert_array_equal(hf.numpy(), want_h.numpy())


def test_extreme_decay_stays_finite():
    B, T, D, N = 1, 32, 16, 4
    rng = np.random.default_rng(3)
    a = np.where(rng.random((B, T, D, N)) < 0.5, 1e-4, 0.99999
                 ).astype(np.float32)
    b = rng.standard_normal((B, T, D, N)).astype(np.float32)
    C = rng.standard_normal((B, T, N)).astype(np.float32)
    (ja, jb, jC), (ta, tb, tC) = _both((a, b, C))
    y, hf = ops.selective_scan(ta, tb, tC)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    for want_y, want_h in (jnp_selective_scan(ja, jb, jC, chunk=16,
                                              d_blk=16),
                           jnp_selective_scan_ref(ja, jb, jC)):
        _close(y, want_y, DECAY_ATOL)
        _close(hf, want_h, DECAY_ATOL)


@pytest.mark.parametrize("impl", ssm.SSM_IMPLS)
def test_model_decomposition_matches_reference(impl):
    """The port's model scan (a = exp(dt·A), b = dt·B·u through the scan
    kernel's entry, then + D·u) against the reference's model scan in
    each impl and against the reference's kernel on the same
    decomposition, at tests/test_kernels.py:153's sizes."""
    rng = np.random.default_rng(11)
    B, S, di, N = 1, 64, 32, 8
    arrays = [rng.standard_normal((B, S, di)) * 0.5,
              np.abs(rng.standard_normal((B, S, di))) * 0.2 + 0.01,
              -(np.abs(rng.standard_normal((di, N))) + 0.1),
              rng.standard_normal((B, S, N)),
              rng.standard_normal((B, S, N)),
              rng.standard_normal(di)]
    jx, tx = _both([x.astype(np.float32) for x in arrays])
    y, h = ssm._selective_scan(*tx, impl=impl)
    y_model, h_model = jnp_model_scan(*jx, impl=impl)
    _close(y, y_model, MODEL_ATOL)
    _close(h, h_model, MODEL_ATOL)
    u, dt, A, Bm, Cm, Dv = jx
    a = jnp.exp(dt[..., None] * A[None, None])
    b = dt[..., None] * Bm[:, :, None, :] * u[..., None]
    y_k, h_k = jnp_selective_scan(a, b, Cm, chunk=16, d_blk=32)
    _close(y, y_k + Dv[None, None] * u, MODEL_ATOL)
    _close(h, h_k, MODEL_ATOL)


@pytest.mark.parametrize("T", [1, 37, 100])
def test_ragged_lengths_match_reference(T):
    """Lengths that no chunk divides (the kernel walks any T); the Pallas
    kernel takes only whole chunks, so the oracle is the reference's."""
    (ja, jb, jC, jh0), (a, b, C, h0) = _both(_scan_inputs(2, T, 24, 4, T))
    y, hf = ops.selective_scan(a, b, C, h0)
    want_y, want_h = jnp_selective_scan_ref(ja, jb, jC, jh0)
    _close(y, want_y, ATOL)
    _close(hf, want_h, ATOL)


def test_no_initial_state_means_zeros_and_inputs_are_cast():
    a, b, C, _ = _scan_inputs(1, 16, 8, 4, 5)
    y0, h0 = ops.selective_scan(*(torch.from_numpy(x) for x in (a, b, C)))
    y1, h1 = ops.selective_scan(*(torch.from_numpy(x).double()
                                  for x in (a, b, C)),
                                torch.zeros((1, 8, 4), dtype=torch.float64))
    assert y1.dtype == torch.float32
    np.testing.assert_array_equal(y0.numpy(), y1.numpy())
    np.testing.assert_array_equal(h0.numpy(), h1.numpy())


def test_empty_sequence_returns_the_initial_state():
    a, b, C, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 0, 8, 4, 6))
    y, hf = ops.selective_scan(a, b, C, h0)
    assert y.shape == (2, 0, 8)
    np.testing.assert_array_equal(hf.numpy(), h0.numpy())


def _bad_inputs():
    a = torch.zeros((1, 8, 4, 16))
    C = torch.zeros((1, 8, 16))
    h0 = torch.zeros((1, 4, 16))
    a3 = torch.zeros((1, 8, 4, 3))
    return [
        ("float64", (a.double(), a.double(), C.double(), h0.double()),
         TypeError),
        ("bf16 C", (a, a, C.bfloat16(), h0), TypeError),
        ("3-D a", (a[0], a[0], C, h0), ValueError),
        ("a, b differ", (a, a[:, :4], C, h0), ValueError),
        ("C of another length", (a, a, C[:, :4], h0), ValueError),
        ("h0 of another width", (a, a, C, h0[:, :2]), ValueError),
        ("state size 3", (a3, a3, torch.zeros((1, 8, 3)),
                          torch.zeros((1, 4, 3))), ValueError),
        ("state size 64", (torch.zeros((1, 2, 1, 64)),) * 2
         + (torch.zeros((1, 2, 64)), torch.zeros((1, 1, 64))), ValueError),
        ("meta device", (a.to("meta"), a.to("meta"), C.to("meta"),
                         h0.to("meta")), ValueError),
        ("mixed devices", (a, a.to("meta"), C, h0), ValueError),
    ]


@pytest.mark.parametrize("case", _bad_inputs(), ids=lambda c: c[0])
def test_wrapper_refuses_bad_inputs(case):
    _, args, err = case
    launches = kernel.selective_scan_fwd.launches
    with pytest.raises(err):
        kernel.selective_scan_fwd(*args)
    assert kernel.selective_scan_fwd.launches == launches


def test_unknown_ssm_impl_raises():
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="ssm_impl"):
        ssm._selective_scan(x, x, torch.zeros((8, 4)), torch.zeros((1, 4, 4)),
                            torch.zeros((1, 4, 4)), torch.zeros(8),
                            impl="parallel")

"""The port's WKV-6 recurrence, held against the reference.

On the CPU the wrapper runs its plain PyTorch version.  These tests hold it
to the reference's Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) and to the reference's sequential
oracle ``wkv6_ref``, on the same numpy-seeded inputs, at the tolerances of
``tests/test_kernels.py``: ``atol`` 5e-4 at its four shapes and across
chunk sizes, 1e-3 under extreme decay.  The reference is imported inside
a fixture, so that the one test that needs the card (marked ``cuda``,
skipped without one) also runs where jax is not installed.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rwkv6_wkv import kernel, ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref  # noqa: E402

ATOL = 5e-4            # tests/test_kernels.py:94
DECAY_ATOL = 1e-3      # tests/test_kernels.py:125

# (B, T, H, n, chunk): tests/test_kernels.py:80-82
SHAPES = [(1, 64, 2, 16, 16), (2, 128, 4, 64, 32), (1, 96, 1, 32, 32),
          (1, 64, 2, 64, 64)]


@pytest.fixture(scope="module")
def ref():
    """The reference's Pallas wrapper (interpret mode off the TPU) and
    its jnp oracle."""
    jnp = pytest.importorskip("jax.numpy")
    ops_mod = pytest.importorskip("repro.kernels.rwkv6_wkv.ops")
    ref_mod = pytest.importorskip("repro.kernels.rwkv6_wkv.ref")

    def run(fn, arrays, **kw):
        y, s = fn(*(None if a is None else jnp.asarray(a) for a in arrays),
                  **kw)
        return np.asarray(y, np.float32), np.asarray(s, np.float32)

    return types.SimpleNamespace(
        wkv6=lambda *a, **kw: run(ops_mod.wkv6, a, **kw),
        wkv6_ref=lambda *a: run(ref_mod.wkv6_ref, a))


def _inputs(B, T, H, n, seed):
    """r, k, v, w ∈ (0, 1), u and s0 as tests/test_kernels.py:85-91 draws
    them, as float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, n)) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, n)) * 0.5 - 1.0))
    u = rng.standard_normal((H, n)) * 0.5
    s0 = rng.standard_normal((B, H, n, n)) * 0.1
    return [x.astype(np.float32) for x in (r, k, v, w, u, s0)]


def _torch(arrays):
    return [torch.from_numpy(x) for x in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol)


@pytest.mark.parametrize("B,T,H,n,chunk", SHAPES)
def test_plain_version_matches_reference(ref, B, T, H, n, chunk):
    arrays = _inputs(B, T, H, n, T + n)
    launches = kernel.wkv6_fwd.launches
    y, sf = ops.wkv6(*_torch(arrays), chunk=chunk)
    assert kernel.wkv6_fwd.launches == launches            # CPU: plain
    assert y.shape == (B, T, H, n) and sf.shape == (B, H, n, n)
    assert y.dtype == sf.dtype == torch.float32
    for want_y, want_s in (ref.wkv6(*arrays, chunk=chunk),
                           ref.wkv6_ref(*arrays)):
        _close(y, want_y, ATOL)
        _close(sf, want_s, ATOL)
    want_y, want_s = wkv6_ref(*_torch(arrays))
    np.testing.assert_array_equal(y.numpy(), want_y.numpy())
    np.testing.assert_array_equal(sf.numpy(), want_s.numpy())


def test_chunk_sizes_give_one_result(ref):
    """tests/test_kernels.py:99-110: the chunk is the reference's tile
    length; the port has none, so any chunk gives the same bits, and both
    match the reference at either chunk."""
    rng = np.random.default_rng(5)
    B, T, H, n = 1, 128, 2, 32
    rkv = [(rng.standard_normal((B, T, H, n)) * 0.4).astype(np.float32)
           for _ in range(3)]
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, n)) - 1)
               ).astype(np.float32)
    u = (rng.standard_normal((H, n)) * 0.3).astype(np.float32)
    arrays = [*rkv, w, u]
    y16, s16 = ops.wkv6(*_torch(arrays), chunk=16)
    y64, s64 = ops.wkv6(*_torch(arrays), chunk=64)
    np.testing.assert_array_equal(y16.numpy(), y64.numpy())
    np.testing.assert_array_equal(s16.numpy(), s64.numpy())
    for chunk in (16, 64):
        want_y, want_s = ref.wkv6(*arrays, chunk=chunk)
        _close(y16, want_y, ATOL)
        _close(s16, want_s, ATOL)


def test_extreme_decay_stays_finite(ref):
    """tests/test_kernels.py:112-125: decays near 0 and near 1."""
    B, T, H, n = 1, 64, 1, 16
    rng = np.random.default_rng(9)
    rkv = [rng.standard_normal((B, T, H, n)).astype(np.float32)
           for _ in range(3)]
    w = np.where(rng.random((B, T, H, n)) < 0.5, 0.01, 0.9999
                 ).astype(np.float32)
    u = np.zeros((H, n), np.float32)
    arrays = [*rkv, w, u]
    y, sf = ops.wkv6(*_torch(arrays))
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    for want_y, want_s in (ref.wkv6(*arrays, chunk=32),
                           ref.wkv6_ref(*arrays)):
        _close(y, want_y, DECAY_ATOL)
        _close(sf, want_s, DECAY_ATOL)


@pytest.mark.parametrize("T", [1, 37, 100])
def test_ragged_lengths_match_reference(ref, T):
    """Lengths that no chunk divides (and one step): the Pallas kernel
    takes only whole chunks, so the oracle is the reference's."""
    arrays = _inputs(2, T, 3, 16, T)
    y, sf = ops.wkv6(*_torch(arrays))
    want_y, want_s = ref.wkv6_ref(*arrays)
    _close(y, want_y, ATOL)
    _close(sf, want_s, ATOL)


def test_no_initial_state_means_zeros_and_inputs_are_cast():
    r, k, v, w, u, _ = _inputs(1, 16, 2, 8, 5)
    y0, s0 = ops.wkv6(*_torch((r, k, v, w, u)))
    y1, s1 = ops.wkv6(*(torch.from_numpy(x).double()
                        for x in (r, k, v, w, u)),
                      torch.zeros((1, 2, 8, 8), dtype=torch.bfloat16))
    assert y1.dtype == s1.dtype == torch.float32
    np.testing.assert_array_equal(y0.numpy(), y1.numpy())
    np.testing.assert_array_equal(s0.numpy(), s1.numpy())


def test_empty_sequence_returns_the_initial_state():
    arrays = _torch(_inputs(2, 0, 2, 16, 6))
    y, sf = ops.wkv6(*arrays)
    assert y.shape == (2, 0, 2, 16)
    np.testing.assert_array_equal(sf.numpy(), arrays[-1].numpy())


def _bad_inputs():
    x = torch.zeros((1, 8, 2, 16))
    u = torch.zeros((2, 16))
    s0 = torch.zeros((1, 2, 16, 16))
    x12 = torch.zeros((1, 8, 2, 12))

    def meta(t):
        return t.to("meta")
    return [
        ("float64", (x.double(),) * 4 + (u.double(), s0.double()),
         TypeError),
        ("bf16 w", (x, x, x, x.bfloat16(), u, s0), TypeError),
        ("3-D r", (x[0], x[0], x[0], x[0], u, s0), ValueError),
        ("k of another length", (x, x[:, :4], x, x, u, s0), ValueError),
        ("u of another width", (x, x, x, x, u[:, :8], s0), ValueError),
        ("s0 of another batch", (x, x, x, x, u, s0.expand(2, -1, -1, -1)),
         ValueError),
        ("head size 12", (x12,) * 4 + (torch.zeros((2, 12)),
                                       torch.zeros((1, 2, 12, 12))),
         ValueError),
        ("head size 128", (torch.zeros((1, 2, 1, 128)),) * 4
         + (torch.zeros((1, 128)), torch.zeros((1, 1, 128, 128))),
         ValueError),
        ("meta device", tuple(map(meta, (x, x, x, x, u, s0))), ValueError),
        ("mixed devices", (x, x, meta(x), x, u, s0), ValueError),
    ]


@pytest.mark.parametrize("case", _bad_inputs(), ids=lambda c: c[0])
def test_wrapper_refuses_bad_inputs(case):
    _, args, err = case
    launches = kernel.wkv6_fwd.launches
    with pytest.raises(err):
        kernel.wkv6_fwd(*args)
    assert kernel.wkv6_fwd.launches == launches


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


# the model's head size across the kernel's 16-step stages (T = 15, 16,
# 17, 49 and one step) with B·H = 3; n = 8 and 16 with one (b, h); and
# the earlier mixed shapes
CARD_SHAPES = ([(1, T, 3, 64) for T in (15, 16, 17, 49, 1)]
               + [(1, T, 1, n) for n in (8, 16) for T in (17, 49)]
               + [(2, 128, 4, 64), (1, 77, 3, 16), (2, 1, 2, 32),
                  (3, 40, 2, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,n", CARD_SHAPES)
def test_kernel_matches_plain_version_on_the_card(card, B, T, H, n):
    arrays = [torch.from_numpy(x).to(card)
              for x in _inputs(B, T, H, n, B * T + n)]
    launches = kernel.wkv6_fwd.launches
    y, sf = kernel.wkv6_fwd(*arrays)
    want_y, want_s = wkv6_ref(*arrays)
    torch.cuda.synchronize()
    assert kernel.wkv6_fwd.launches == launches + 1
    torch.testing.assert_close(y, want_y, atol=ATOL, rtol=0)
    torch.testing.assert_close(sf, want_s, atol=ATOL, rtol=0)

"""One-card training on the card: the flash, selective-scan and wkv6
backward kernels against their plain versions, and the launches a train
step makes.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_card.py

Inputs are drawn with numpy from a seed.  The backward kernel runs bf16
on the tensor cores (TMA and ``wgmma`` at hd 64-256, ``mma.sync`` at 16
and 32; P and dS rounded to bf16 as they enter the products) and float32
on the CUDA cores, the plain version in float32 throughout, so the gate is
a tile-sized block's: each block of 64 rows (n
elements) of each batch row and head within rtol·||plain|| + atol·√n,
(1e-5, 1e-7) in float32 and (1e-2, 1e-5) in bf16, with the plain backward
fed the plain forward's output and ``lse``.  ``lse`` itself is held
within 1e-5 relative and absolute.  The selective-scan backward runs in
float32 on both sides and is held by the same gate at the float32
tolerance, in blocks of 64 time steps (``scan_ref.bwd_block_errs``), its
planted faults (``scan_ref.bwd_planted_faults``) failing it; the wkv6
backward likewise, with its own gate and faults (``wkv_ref``).  Nothing
here changes process-wide state: each model draws from its own
generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkv  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref  # noqa: E402
from repro_torch.kernels.selective_scan import kernel as scan  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.selective_scan import ref as scan_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = {torch.float32: (1e-5, 1e-7), torch.bfloat16: (1e-2, 1e-5)}


def _block_err(got, want, dtype, rows=64):
    """The block gate (``ref.bwd_block_err``) at ``TOL[dtype]``: at most 1
    where every block of ``rows`` rows is within it."""
    return ref.bwd_block_err(got, want, *TOL[dtype], rows=rows)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(dev, B, S, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
                dtype).to(dev)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


# every head size, GQA groups of 1-5, windows, ragged S across the tiles;
# then the Hopper kernels' tile edges (hd 64-256): S at a tile's size and
# one row either side (pass 2's blocks of 128 keys at hd 64 and 128, 64 at
# hd 256, and its streamed 128 queries at hd 64; pass 3's blocks of 192
# query rows at hd 64 and 128, 128 at hd 256, and its streamed 32 keys at
# hd 256), B = 2, GQA groups of 4 and 6 at hd 128 (granite-3-8b's 32/8,
# mistral-nemo-12b's 48/8), a window of a tile's size (and, in
# WINDOW_ONE, bf16 only, a window of 1)
CASES = [(2, 77, 4, 1, 16, 0), (1, 130, 4, 2, 32, 9), (1, 200, 8, 2, 64, 0),
         (1, 129, 4, 4, 128, 40), (1, 100, 4, 1, 256, 0),
         (1, 300, 4, 1, 256, 64), (1, 1, 4, 1, 64, 0), (1, 96, 25, 5, 64, 33),
         (1, 127, 4, 2, 64, 0), (1, 128, 4, 2, 64, 0), (1, 129, 4, 2, 64, 0),
         (1, 127, 4, 1, 128, 0), (1, 128, 4, 1, 128, 0),
         (1, 129, 4, 1, 128, 0), (1, 63, 4, 1, 256, 0), (1, 64, 4, 1, 256, 0),
         (1, 65, 4, 1, 256, 0), (1, 127, 4, 1, 256, 0),
         (1, 129, 4, 1, 256, 0), (2, 200, 4, 1, 256, 0),
         (2, 150, 4, 2, 128, 16), (2, 140, 8, 8, 64, 0),
         (1, 256, 8, 2, 128, 0), (1, 256, 12, 2, 128, 0),
         (1, 300, 12, 2, 128, 37), (1, 300, 4, 2, 128, 128),
         (1, 300, 4, 1, 256, 32), (1, 300, 4, 4, 64, 128),
         (1, 191, 4, 2, 64, 0), (1, 192, 4, 1, 128, 0),
         (1, 193, 4, 2, 64, 0), (1, 193, 4, 1, 128, 0),
         (1, 31, 4, 1, 256, 0), (1, 33, 4, 1, 256, 0)]
# A window of 1 leaves each query its own key: P = 1 and dS = dP - D = 0,
# so dQ and dK are float32 rounding of that cancellation on both sides,
# which the float32 gate's atol (sized for one cancelling row) does not
# bound.  In bf16 the gate holds the Hopper kernels' masks at that edge;
# in float32 dQ and dK are held to the cancellation's size instead
# (``ref.bwd_cancel_bound``) and dV to the gate.
WINDOW_ONE = [(1, 200, 4, 1, 256, 1), (1, 200, 4, 2, 128, 1),
              (1, 200, 4, 4, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,win", CASES)
def test_backward_kernel_matches_plain_version(card, B, S, H, KV, hd, win,
                                               dtype):
    _check_backward(card, B, S, H, KV, hd, win, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,win", WINDOW_ONE)
def test_backward_kernel_at_window_one(card, B, S, H, KV, hd, win):
    _check_backward(card, B, S, H, KV, hd, win, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,win", WINDOW_ONE)
def test_backward_kernel_at_window_one_float32(card, B, S, H, KV, hd, win):
    """Float32 at window 1: dQ and dK within rtol·||plain|| + the block's
    cancellation bound, dV within the gate; a skipped tile (one 64-row
    tile of dV, which at window 1 is that tile's whole contribution) must
    fail it.  Two calls bit-identical."""
    dtype = torch.float32
    q, k, v, g = _inputs(card, B, S, H, KV, hd, dtype, S + hd + win)
    out, lse = kernel.flash_attention_fwd(q, k, v, window=win,
                                          return_lse=True)
    out_p = kernel.flash_attention_plain(q, k, v, window=win)
    lse_p = kernel.flash_attention_lse_plain(q, k, window=win)
    got = kernel.flash_attention_bwd(q, k, v, out, lse, g, window=win)
    again = kernel.flash_attention_bwd(q, k, v, out, lse, g, window=win)
    want = kernel.flash_attention_bwd_plain(q, k, v, out_p, lse_p, g,
                                            window=win)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    rtol, _ = TOL[dtype]
    dq_rows, dk_rows = ref.bwd_cancel_bound(q, k, v, g)
    assert ref.bwd_block_err(got[0], want[0], rtol, 0.0,
                             row_bound=dq_rows) <= 1
    assert ref.bwd_block_err(got[1], want[1], rtol, 0.0,
                             row_bound=dk_rows) <= 1
    assert _block_err(got[2], want[2], dtype) <= 1
    skipped = got[2].clone()
    t0 = S // 2 // 64 * 64
    skipped[:, t0:t0 + 64] = 0
    assert _block_err(skipped, want[2], dtype) > 1


def _check_backward(card, B, S, H, KV, hd, win, dtype):
    """The kernel's dq, dk, dv within the block gate of the plain
    backward's, two calls bit-identical, each counted on its route."""
    q, k, v, g = _inputs(card, B, S, H, KV, hd, dtype, S + hd + win)
    out, lse = kernel.flash_attention_fwd(q, k, v, window=win,
                                          return_lse=True)
    lse_p = kernel.flash_attention_lse_plain(q, k, window=win)
    out_p = kernel.flash_attention_plain(q, k, v, window=win)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    assert _block_err(out, out_p, dtype) <= 1
    launches = kernel.flash_attention_bwd.launches
    routes = dict(kernel.flash_attention_bwd.launches_by_route)
    got = kernel.flash_attention_bwd(q, k, v, out, lse, g, window=win)
    again = kernel.flash_attention_bwd(q, k, v, out, lse, g, window=win)
    assert kernel.flash_attention_bwd.launches == \
        launches + 2 * kernel.BWD_LAUNCHES_PER_CALL
    route = kernel.bwd_route(dtype, hd)
    routes[route] += 2 * kernel.BWD_LAUNCHES_PER_CALL
    assert kernel.flash_attention_bwd.launches_by_route == routes
    assert route == ("f32" if dtype == torch.float32
                     else "hopper" if hd >= 64 else "mma")
    want = kernel.flash_attention_bwd_plain(q, k, v, out_p, lse_p, g,
                                            window=win)
    torch.cuda.synchronize()
    for name, a, b, w in zip("qkv", got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, b), f"d{name} differs between repeats"
        err = _block_err(a, w, dtype)
        assert err <= 1, (name, err)


@pytest.mark.cuda
def test_function_runs_both_kernels(card):
    q, k, v, g = _inputs(card, 2, 64, 4, 1, 64, torch.bfloat16, 0)
    held = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kernel.zero_launches()
    out = ops.flash_attention(*held, window=16)
    assert kernel.flash_attention_fwd.launches == 1
    grads = torch.autograd.grad(out, held, g)
    assert kernel.flash_attention_bwd.launches == kernel.BWD_LAUNCHES_PER_CALL
    lse = kernel.flash_attention_lse_plain(q, k, window=16)
    out_p = kernel.flash_attention_plain(q, k, v, window=16)
    want = kernel.flash_attention_bwd_plain(q, k, v, out_p, lse, g,
                                            window=16)
    for a, w in zip(grads, want):
        err = _block_err(a, w, torch.bfloat16)
        assert err <= 1, err
    with torch.no_grad():
        assert ops.flash_attention(*held, window=16).grad_fn is None
    assert kernel.flash_attention_bwd.launches == kernel.BWD_LAUNCHES_PER_CALL


def _smoke(arch, dev, **change):
    cfg = get_config(arch, smoke=True).replace(**change)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 64))).to(dev)}
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("policy,fwd_per_layer", [("full", 2), ("dots", 2),
                                                  ("none", 1)])
def test_train_step_launches_and_repeats(card, policy, fwd_per_layer):
    """A gemma3-1b smoke step: one forward launch a layer (two under
    recomputing policies), one backward call (three launches) a layer, and
    two runs from the same state give bit-identical parameters."""
    cfg, params, batch = _smoke("gemma3-1b", card, remat_policy=policy)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    runs = []
    for _ in range(2):
        p = adamw.tree_map(torch.clone, params)
        kernel.zero_launches()
        p, s, m = step(p, adamw.init_opt_state(p), batch)
        torch.cuda.synchronize()
        assert kernel.flash_attention_fwd.launches == \
            fwd_per_layer * cfg.n_layers
        assert kernel.flash_attention_bwd.launches == \
            kernel.BWD_LAUNCHES_PER_CALL * cfg.n_layers
        assert np.isfinite(float(m["loss"]))
        runs.append(p)
    for a, b in zip(adamw.tree_leaves(runs[0]), adamw.tree_leaves(runs[1])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,fwd_per_layer", [("full", 2), ("none", 1)])
def test_hybrid_train_step_launches_and_repeats(card, policy, fwd_per_layer):
    """A hymba-1.5b smoke step: one scan and one flash forward launch a
    layer (two under ``full``), one scan backward call (two launches) and
    one flash backward call (three) a layer, and two runs from the same
    state give bit-identical losses and parameters."""
    cfg, params, batch = _smoke("hymba-1.5b", card, remat_policy=policy)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    runs = []
    for _ in range(2):
        p = adamw.tree_map(torch.clone, params)
        kernel.zero_launches()
        scan.zero_launches()
        p, s, m = step(p, adamw.init_opt_state(p), batch)
        torch.cuda.synchronize()
        assert (scan.selective_scan_fwd.launches,
                scan.selective_scan_bwd.launches,
                kernel.flash_attention_fwd.launches,
                kernel.flash_attention_bwd.launches) == (
            fwd_per_layer * cfg.n_layers,
            scan.BWD_LAUNCHES_PER_CALL * cfg.n_layers,
            fwd_per_layer * cfg.n_layers,
            kernel.BWD_LAUNCHES_PER_CALL * cfg.n_layers)
        assert np.isfinite(float(m["loss"]))
        runs.append((float(m["loss"]), p))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(adamw.tree_leaves(runs[0][1]),
                    adamw.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def _scan_inputs(dev, B, T, D, N, seed, h0=True, dh_last=True):
    """a ∈ (0, 1] as tests/test_kernels.py draws it, b, C, h0 (zeros when
    not ``h0``), dy and dh_last (None when not ``dh_last``), float32."""
    rng = np.random.default_rng(seed)
    arrays = [np.exp(-np.exp(rng.standard_normal((B, T, D, N)) * 0.5 - 1)),
              rng.standard_normal((B, T, D, N)) * 0.3,
              rng.standard_normal((B, T, N)),
              rng.standard_normal((B, D, N)) * 0.2 * h0,
              rng.standard_normal((B, T, D)),
              rng.standard_normal((B, D, N))]
    out = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in arrays]
    return out[:5] + [out[5] if dh_last else None]


# (B, T, D, N, h0, dh_last): T of one step, 17, a non-multiple of the
# 16-step chunk above it and a whole number of chunks; D·N off the 256-lane
# block and on it; every state size; zero h0 and no dh_last
SCAN_CASES = [(1, 1, 8, 16, True, True), (2, 17, 24, 16, True, True),
              (2, 100, 50, 1, True, True), (1, 33, 41, 32, True, False),
              (3, 64, 300, 8, False, True), (2, 48, 64, 4, True, True),
              (1, 77, 100, 2, False, False), (2, 130, 160, 16, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,N,h0,dh", SCAN_CASES)
def test_scan_backward_kernel_matches_plain_version(card, B, T, D, N, h0,
                                                    dh):
    """The forward's checkpoints within 1e-5 of the plain version's; the
    backward kernel's four gradients within the float32 block gate of the
    plain backward's, two calls bit-identical, each call two launches; each
    planted fault fails the gate."""
    a, b, C, h, dy, dh_last = _scan_inputs(card, B, T, D, N, T + D + N,
                                           h0, dh)
    rtol, atol = TOL[torch.float32]
    fwd = scan.selective_scan_fwd.launches
    y, h_last, hck = scan.selective_scan_fwd(a, b, C, h, checkpoints=True)
    assert scan.selective_scan_fwd.launches == fwd + 1
    y_p, h_p, hck_p = scan.selective_scan_checkpoints_plain(a, b, C, h)
    for got, want in ((y, y_p), (h_last, h_p), (hck, hck_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    launches = scan.selective_scan_bwd.launches
    got = scan.selective_scan_bwd(a, b, C, h, dy, dh_last, checkpoints=hck)
    again = scan.selective_scan_bwd(a, b, C, h, dy, dh_last,
                                    checkpoints=hck)
    assert scan.selective_scan_bwd.launches == \
        launches + 2 * scan.BWD_LAUNCHES_PER_CALL
    want = scan.selective_scan_bwd_plain(a, b, C, h, dy, dh_last)
    torch.cuda.synchronize()
    for name, x, x2, w in zip(("da", "db", "dC", "dh0"), got, again, want):
        assert x.shape == w.shape and x.dtype == w.dtype == torch.float32
        assert torch.equal(x, x2), f"{name} differs between repeats"
    errs = scan_ref.bwd_block_errs(got, want, rtol, atol)
    assert max(errs) <= 1, errs
    faults = scan_ref.bwd_planted_faults(a, b, C, h, dy, dh_last, got, want)
    assert len(faults) == 1 + (dh_last is not None)
    for name, faulty in faults.items():
        assert max(scan_ref.bwd_block_errs(faulty, want, rtol, atol)) > 1, \
            name


@pytest.mark.cuda
def test_scan_backward_kernel_at_no_steps(card):
    """T = 0: no launch; da, db, dC empty, dh0 = dh_last."""
    a, b, C, h, dy, dh_last = _scan_inputs(card, 2, 0, 8, 4, 0)
    y, h_last, hck = scan.selective_scan_fwd(a, b, C, h, checkpoints=True)
    assert hck.shape == (2, 0, 8, 4) and torch.equal(h_last, h)
    launches = scan.selective_scan_bwd.launches
    da, db, dC, dh0 = scan.selective_scan_bwd(a, b, C, h, dy, dh_last,
                                              checkpoints=hck)
    assert scan.selective_scan_bwd.launches == launches
    assert da.shape == (2, 0, 8, 4) and dC.shape == (2, 0, 4)
    assert torch.equal(dh0, dh_last)
    with pytest.raises(ValueError, match="checkpoints"):
        scan.selective_scan_bwd(a, b, C, h, dy, dh_last)


@pytest.mark.cuda
def test_scan_function_runs_both_kernels(card):
    a, b, C, h, dy, dh_last = _scan_inputs(card, 2, 40, 24, 16, 1)
    held = [x.clone().requires_grad_(True) for x in (a, b, C, h)]
    scan.zero_launches()
    y, h_last = scan_ops.selective_scan(*held)
    assert scan.selective_scan_fwd.launches == 1
    grads = torch.autograd.grad((y, h_last), held, (dy, dh_last))
    assert scan.selective_scan_bwd.launches == scan.BWD_LAUNCHES_PER_CALL
    want = scan.selective_scan_bwd_plain(a, b, C, h, dy, dh_last)
    errs = scan_ref.bwd_block_errs(grads, want, *TOL[torch.float32])
    assert max(errs) <= 1, errs
    with torch.no_grad():
        y2, _ = scan_ops.selective_scan(*held)
    assert y2.grad_fn is None and scan.selective_scan_fwd.launches == 2
    assert scan.selective_scan_bwd.launches == scan.BWD_LAUNCHES_PER_CALL


def _wkv_inputs(dev, B, T, H, n, seed, s0=True, dS_T=True, strong=False):
    """r, k, v, w (as tests/test_kernels.py draws it, or in (0.01, 0.5)
    where ``strong``), u, s0 (zeros when not ``s0``), dy and dS_T (None
    when not ``dS_T``), float32."""
    rng = np.random.default_rng(seed)
    w = (rng.uniform(0.01, 0.5, (B, T, H, n)) if strong else
         np.exp(-np.exp(rng.standard_normal((B, T, H, n)) * 0.5 - 1)))
    arrays = [rng.standard_normal((B, T, H, n)) * 0.5,
              rng.standard_normal((B, T, H, n)) * 0.5,
              rng.standard_normal((B, T, H, n)) * 0.5, w,
              rng.standard_normal((H, n)) * 0.5,
              rng.standard_normal((B, H, n, n)) * 0.1 * s0,
              rng.standard_normal((B, T, H, n)),
              rng.standard_normal((B, H, n, n))]
    out = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in arrays]
    return out[:7] + [out[7] if dS_T else None]


# (B, T, H, n, s0, dS_T, strong): one step, T 17 and off the 16-step TMA
# stage and the 8-step chunk, every head size, zero s0 and no dS_T, strong
# decays; then the edges of the backward's cluster split: one (b, h) (one
# cluster of 4 CTAs at n 64, 2 at n 32, one CTA below), T 1, 7 (less than
# a chunk), 9 and 15 (one past and one short of a chunk), strong decays
WKV_CASES = [(1, 1, 2, 64, True, True, False),
             (2, 17, 3, 64, True, True, False),
             (2, 100, 2, 8, True, True, False),
             (1, 33, 1, 32, False, False, False),
             (2, 64, 2, 16, True, True, True),
             (1, 130, 4, 64, True, False, True),
             (1, 1, 1, 64, True, False, False),
             (1, 7, 1, 64, True, True, False),
             (1, 9, 1, 64, False, True, True),
             (1, 15, 1, 32, True, True, False),
             (1, 9, 1, 16, True, True, True),
             (1, 7, 1, 8, True, False, False),
             (1, 23, 1, 64, True, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,n,s0,dS,strong", WKV_CASES)
def test_wkv_backward_kernel_matches_plain_version(card, B, T, H, n, s0, dS,
                                                   strong):
    """The forward's checkpoints within 1e-5 of the plain version's; the
    backward kernel's six gradients within the float32 block gate of the
    plain backward's, two calls bit-identical, each call two launches; each
    planted fault fails the gate."""
    r, k, v, w, u, s, dy, dS_T = _wkv_inputs(card, B, T, H, n, T + H + n,
                                              s0, dS, strong)
    rtol, atol = TOL[torch.float32]
    fwd = wkv.wkv6_fwd.launches
    y, s_final, ck = wkv.wkv6_fwd(r, k, v, w, u, s, checkpoints=True)
    assert wkv.wkv6_fwd.launches == fwd + 1
    y_p, s_p, ck_p = wkv.wkv6_checkpoints_plain(r, k, v, w, u, s)
    for got, want in ((y, y_p), (s_final, s_p), (ck, ck_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    launches = wkv.wkv6_bwd.launches
    got = wkv.wkv6_bwd(r, k, v, w, u, s, dy, dS_T, checkpoints=ck)
    again = wkv.wkv6_bwd(r, k, v, w, u, s, dy, dS_T, checkpoints=ck)
    assert wkv.wkv6_bwd.launches == \
        launches + 2 * wkv.BWD_LAUNCHES_PER_CALL
    want = wkv.wkv6_bwd_plain(r, k, v, w, u, s, dy, dS_T)
    torch.cuda.synchronize()
    for name, x, x2, ww in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                               again, want):
        assert x.shape == ww.shape and x.dtype == ww.dtype == torch.float32
        assert torch.equal(x, x2), f"{name} differs between repeats"
    errs = wkv_ref.bwd_block_errs(got, want, rtol, atol)
    assert max(errs) <= 1, errs
    faults = wkv_ref.bwd_planted_faults(r, k, v, w, u, s, dy, dS_T, got,
                                        want)
    assert len(faults) == 2 + (dS_T is not None) + (dS_T is not None
                                                   or T > 1)
    for name, faulty in faults.items():
        assert max(wkv_ref.bwd_block_errs(faulty, want, rtol, atol)) > 1, \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("n,cluster", [(8, 1), (16, 1), (32, 2), (64, 2)])
def test_wkv_backward_occupancy(card, n, cluster):
    """The walk back's split: dS's rows over a cluster of ``cluster`` CTAs;
    at n 64, at least 2 CTAs (8 warps) an SM."""
    occ = wkv.bwd_occupancy(n)
    assert occ["cluster"] == cluster and occ["active_clusters"] > 0
    assert occ["ctas_per_sm"] >= 1
    if n == 64:
        assert occ["ctas_per_sm"] >= 2 and occ["warps_per_sm"] >= 8, occ


@pytest.mark.cuda
def test_wkv_backward_kernel_at_no_steps(card):
    """T = 0: ds0 = dS_T and du = 0 from the kernel; no checkpoints, no
    backward without them."""
    r, k, v, w, u, s, dy, dS_T = _wkv_inputs(card, 2, 0, 2, 16, 0)
    y, s_final, ck = wkv.wkv6_fwd(r, k, v, w, u, s, checkpoints=True)
    assert ck.shape == (2, 2, 0, 16, 16) and torch.equal(s_final, s)
    dr, dk, dv, dw, du, ds0 = wkv.wkv6_bwd(r, k, v, w, u, s, dy, dS_T,
                                           checkpoints=ck)
    torch.cuda.synchronize()
    assert all(x.shape == (2, 0, 2, 16) for x in (dr, dk, dv, dw))
    assert torch.equal(ds0, dS_T) and torch.equal(du, torch.zeros_like(u))
    with pytest.raises(ValueError, match="checkpoints"):
        wkv.wkv6_bwd(r, k, v, w, u, s, dy, dS_T)


@pytest.mark.cuda
def test_wkv_function_runs_both_kernels(card):
    r, k, v, w, u, s, dy, dS_T = _wkv_inputs(card, 2, 40, 3, 64, 1)
    held = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, s)]
    wkv.zero_launches()
    y, s_final = wkv_ops.wkv6(*held)
    assert (wkv.wkv6_fwd.launches, wkv.wkv6_fwd.checkpoint_launches) == \
        (1, 1)
    grads = torch.autograd.grad((y, s_final), held, (dy, dS_T))
    assert wkv.wkv6_bwd.launches == wkv.BWD_LAUNCHES_PER_CALL
    want = wkv.wkv6_bwd_plain(r, k, v, w, u, s, dy, dS_T)
    errs = wkv_ref.bwd_block_errs(grads, want, *TOL[torch.float32])
    assert max(errs) <= 1, errs
    with torch.no_grad():
        y2, _ = wkv_ops.wkv6(*held)
    assert y2.grad_fn is None
    assert (wkv.wkv6_fwd.launches, wkv.wkv6_fwd.checkpoint_launches) == \
        (2, 1)
    assert wkv.wkv6_bwd.launches == wkv.BWD_LAUNCHES_PER_CALL


@pytest.mark.cuda
@pytest.mark.parametrize("policy,fwd_per_layer", [("full", 2), ("none", 1)])
def test_rwkv_train_step_launches_and_repeats(card, policy, fwd_per_layer):
    """An rwkv6-7b smoke step: one wkv6 forward launch a layer (two under
    ``full``), one wkv6 backward call (two launches) a layer and no flash
    launch, and two runs from the same state give bit-identical losses and
    parameters; serving (under no_grad) writes no checkpoints."""
    cfg, params, batch = _smoke("rwkv6-7b", card, remat_policy=policy)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    runs = []
    for _ in range(2):
        p = adamw.tree_map(torch.clone, params)
        kernel.zero_launches()
        wkv.zero_launches()
        p, s, m = step(p, adamw.init_opt_state(p), batch)
        torch.cuda.synchronize()
        assert (wkv.wkv6_fwd.launches, wkv.wkv6_fwd.checkpoint_launches,
                wkv.wkv6_bwd.launches, kernel.flash_attention_fwd.launches,
                kernel.flash_attention_bwd.launches) == (
            fwd_per_layer * cfg.n_layers, fwd_per_layer * cfg.n_layers,
            wkv.BWD_LAUNCHES_PER_CALL * cfg.n_layers, 0, 0)
        assert np.isfinite(float(m["loss"]))
        runs.append((float(m["loss"]), p))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(adamw.tree_leaves(runs[0][1]),
                    adamw.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
    wkv.zero_launches()
    with torch.no_grad():
        T.prefill(params, cfg, batch)
    assert (wkv.wkv6_fwd.launches, wkv.wkv6_fwd.checkpoint_launches,
            wkv.wkv6_bwd.launches) == (cfg.n_layers, 0, 0)

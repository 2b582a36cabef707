"""The port's WKV-6 backward, held against the reference.

The reference has no backward kernel: it trains rwkv by differentiating
its ``lax.scan`` with jax's autodiff.  On the CPU the backward wrapper runs
its plain PyTorch version, ``wkv6_bwd_ref``; these tests hold it to
``jax.vjp`` of the reference's ``wkv6_ref`` (rtol = atol = 1e-5 in
float32) under weak and strong decays, hold :class:`WKV6`'s gradient to
autograd through the plain forward (1e-5), check it in float64 with
``gradcheck``, and hold the time-mix's gradients to ``jax.vjp`` of the
reference's ``rwkv_time_forward`` in its ``scan`` form, for each of the
port's ``time_mix_impl`` (each leaf within 1e-4 of its max |gradient|),
and hold the card's gate (``bwd_block_errs``) to passing the plain
backward against ``jax.vjp`` and failing every planted fault.
Inputs are drawn with numpy from a seed, at shapes no larger than [2, 64,
4, 16] (n = 32 at one head).  The CUDA kernel is compared with the same
plain version on the card (``tests/test_torch_train_card.py``,
``chip_smoke.py`` phase 16j).
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.kernels.rwkv6_wkv.ref import (  # noqa: E402
    wkv6_ref as jnp_wkv6_ref)
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel, ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import (  # noqa: E402
    bwd_block_errs, bwd_planted_faults, wkv6_bwd_ref, wkv6_ref)
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 1e-5             # float32, relative and absolute
MODEL_TOL = 1e-4       # the time-mix's gradients: each over its max
# the card's gate (chip_smoke's BWD_GATE["float32"], rtol and atol): each
# block of 64 steps within rtol·||want|| + atol·√n
GATE = (1e-5, 1e-7)
# (B, T, H, n) of the planted faults' test: a cluster of one CTA (n 16),
# of 4 (n 64), and one step at n 8
FAULT_SHAPES = [(2, 17, 3, 16), (1, 33, 2, 64), (1, 1, 2, 8)]

# (B, T, H, n): one step, T across the 8-step chunk, every head size the
# kernel takes below 64
SHAPES = [(1, 1, 2, 8), (2, 17, 3, 16), (1, 9, 1, 32), (2, 64, 4, 16),
          (2, 23, 2, 8)]
# w's draw: near 1 (rwkv6-7b's w_base of -6 gives 0.9975), or strong
DECAYS = {"weak": (0.9, 1.0), "strong": (0.01, 0.5)}


def _inputs(B, T, H, n, seed, decay="weak"):
    """r, k, v, w in DECAYS[decay], u, a nonzero s0, dy and dS_T, float32
    numpy."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, T, H, n)) * 0.5,
              rng.standard_normal((B, T, H, n)) * 0.5,
              rng.standard_normal((B, T, H, n)) * 0.5,
              rng.uniform(*DECAYS[decay], (B, T, H, n)),
              rng.standard_normal((H, n)) * 0.5,
              rng.standard_normal((B, H, n, n)) * 0.1,
              rng.standard_normal((B, T, H, n)),
              rng.standard_normal((B, H, n, n))]
    return [x.astype(np.float32) for x in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("with_dS", [True, False])
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("B,T,H,n", SHAPES)
def test_plain_backward_matches_jax_vjp(B, T, H, n, decay, with_dS):
    arrays = _inputs(B, T, H, n, B + T + H + n, decay)
    dy, dS = arrays[6], arrays[7] if with_dS else np.zeros_like(arrays[7])
    want = jax.jit(lambda xs, ct: jax.vjp(jnp_wkv6_ref, *xs)[1](ct))(
        [jnp.asarray(x) for x in arrays[:6]],
        (jnp.asarray(dy), jnp.asarray(dS)))
    launches = kernel.wkv6_bwd.launches
    got = kernel.wkv6_bwd(*(torch.from_numpy(x) for x in arrays[:7]),
                          torch.from_numpy(dS) if with_dS else None)
    assert kernel.wkv6_bwd.launches == launches            # CPU: plain
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("with_dS", [True, False])
@pytest.mark.parametrize("B,T,H,n", FAULT_SHAPES)
def test_planted_faults_fail_the_gate(B, T, H, n, with_dS):
    """The card's gate (``bwd_block_errs`` at ``GATE``) against ``jax.vjp``
    of the reference: the plain backward within it, and every planted fault
    built from the plain result above it.  "one row group's share of dv
    dropped" is planted wherever dS_t is not 0 at every step."""
    arrays = _inputs(B, T, H, n, 11 * T + n)
    dy, dS = arrays[6], arrays[7] if with_dS else np.zeros_like(arrays[7])
    want = jax.jit(lambda xs, ct: jax.vjp(jnp_wkv6_ref, *xs)[1](ct))(
        [jnp.asarray(x) for x in arrays[:6]],
        (jnp.asarray(dy), jnp.asarray(dS)))
    want = [torch.from_numpy(np.array(x)) for x in want]
    held = [torch.from_numpy(x) for x in arrays[:7]]
    dS_T = torch.from_numpy(arrays[7]) if with_dS else None
    plain = kernel.wkv6_bwd(*held, dS_T)
    assert max(bwd_block_errs(plain, want, *GATE)) <= 1
    faults = bwd_planted_faults(*held, dS_T, plain, plain)
    assert set(faults) == (
        {"u term of dk dropped", "S read one step late"}
        | ({"dS_T dropped"} if with_dS else set())
        | ({"one row group's share of dv dropped"} if with_dS or T > 1
           else set()))
    for name, faulty in faults.items():
        assert max(bwd_block_errs(faulty, want, *GATE)) > 1, name


@pytest.mark.parametrize("B,T,H,n", SHAPES)
def test_function_gradient_matches_autograd_of_the_plain_forward(B, T, H,
                                                                 n):
    arrays = _inputs(B, T, H, n, 7 * T + n, "strong" if T % 2 else "weak")
    dy, dS = (torch.from_numpy(x) for x in arrays[6:])
    held = [torch.from_numpy(x).requires_grad_(True) for x in arrays[:6]]
    y, s_final = ops.wkv6(*held)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    got = torch.autograd.grad((y, s_final), held, (dy, dS))
    plain = [torch.from_numpy(x).requires_grad_(True) for x in arrays[:6]]
    y_p, s_p = wkv6_ref(*plain)
    _close(y.detach(), y_p.detach(), 0)
    want = torch.autograd.grad((y_p, s_p), plain, (dy, dS))
    for g, w in zip(got, want):
        _close(g, w)


def test_function_gradient_carries_the_casts():
    """bf16 r, k, v, w: the casts to float32 sit outside the Function, so
    each input's gradient comes back in its own type."""
    r, k, v, w, u, s0, dy, _ = _inputs(1, 9, 2, 8, 2)
    held = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
            for x in (r, k, v, w)]
    y, _ = ops.wkv6(*held, torch.from_numpy(u), torch.from_numpy(s0))
    grads = torch.autograd.grad(y, held, torch.from_numpy(dy))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4
    want = wkv6_bwd_ref(*(x.detach().float() for x in held),
                        torch.from_numpy(u), torch.from_numpy(s0),
                        torch.from_numpy(dy))
    for g, w in zip(grads, want):
        _close(g.float(), w.to(torch.bfloat16).float())


class _Plain(torch.autograd.Function):
    """The arithmetic of :class:`ops.WKV6` with the plain forward and
    backward, in the inputs' type (``gradcheck`` wants float64; the
    kernels' wrappers take float32 only)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        y, s_final, _ = kernel.wkv6_checkpoints_plain(r, k, v, w, u, s0)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, dS_T):
        return kernel.wkv6_bwd_plain(*ctx.saved_tensors, dy, dS_T)


@pytest.mark.parametrize("T", [1, 5])
def test_plain_backward_passes_gradcheck_in_float64(T):
    rng = np.random.default_rng(T)
    B, H, n = 1, 2, 3
    held = [torch.from_numpy(x).requires_grad_(True) for x in (
        rng.standard_normal((B, T, H, n)), rng.standard_normal((B, T, H, n)),
        rng.standard_normal((B, T, H, n)), rng.uniform(0.1, 1.0, (B, T, H, n)),
        rng.standard_normal((H, n)), rng.standard_normal((B, H, n, n)))]
    assert torch.autograd.gradcheck(_Plain.apply, held)


@pytest.mark.parametrize("T", [0, 1, 8, 9, 17])
def test_checkpoints_are_the_states_entering_each_chunk(T):
    r, k, v, w, u, s0, _, _ = (torch.from_numpy(x)
                               for x in _inputs(2, T, 2, 8, T))
    y, s_final, ck = kernel.wkv6_fwd(r, k, v, w, u, s0, checkpoints=True)
    y_p, s_p = kernel.wkv6_fwd(r, k, v, w, u, s0)
    assert torch.equal(y, y_p) and torch.equal(s_final, s_p)
    assert ck.shape == (2, 2, kernel.n_chunks(T), 8, 8)
    for c in range(kernel.n_chunks(T)):
        t = c * kernel.CHUNK
        _, want = wkv6_ref(r[:, :t], k[:, :t], v[:, :t], w[:, :t], u, s0)
        assert torch.equal(ck[:, :, c], want)


def test_backward_at_no_steps():
    r, k, v, w, u, s0, dy, dS = (torch.from_numpy(x)
                                 for x in _inputs(2, 0, 2, 8, 0))
    dr, dk, dv, dw, du, ds0 = kernel.wkv6_bwd(r, k, v, w, u, s0, dy, dS)
    assert all(x.shape == (2, 0, 2, 8) for x in (dr, dk, dv, dw))
    assert torch.equal(du, torch.zeros_like(u)) and torch.equal(ds0, dS)
    assert torch.equal(kernel.wkv6_bwd(r, k, v, w, u, s0, dy)[5],
                       torch.zeros_like(s0))


def _bad_backward_inputs():
    r, k, v, w, u, s0, dy, dS = (torch.from_numpy(x)
                                 for x in _inputs(1, 9, 2, 8, 1))
    ck = torch.zeros((1, 2, 2, 8, 8))
    ok = (r, k, v, w, u, s0, dy, dS, ck)

    def but(i, x):
        return ok[:i] + (x,) + ok[i + 1:]

    return [
        ("dy of another length", but(6, dy[:, :4]), ValueError),
        ("dS_T of another width", but(7, dS[..., :4]), ValueError),
        ("checkpoints of another count",
         but(8, torch.zeros((1, 2, 3, 8, 8))), ValueError),
        ("head size 4", tuple(x[..., :4] for x in ok[:4]) + (
            u[:, :4], s0[..., :4, :4], dy[..., :4], dS[..., :4, :4],
            ck[..., :4, :4]), ValueError),
        ("float64 dy", but(6, dy.double()), TypeError),
        ("bf16 dS_T", but(7, dS.bfloat16()), TypeError),
        ("meta device", tuple(x.to("meta") for x in ok), ValueError),
        ("dy on another device", but(6, dy.to("meta")), ValueError),
    ]


@pytest.mark.parametrize("case", _bad_backward_inputs(), ids=lambda c: c[0])
def test_backward_wrapper_refuses_bad_inputs(case):
    _, (r, k, v, w, u, s0, dy, dS, ck), err = case
    launches = kernel.wkv6_bwd.launches
    with pytest.raises(err):
        kernel.wkv6_bwd(r, k, v, w, u, s0, dy, dS, checkpoints=ck)
    assert kernel.wkv6_bwd.launches == launches


def test_serving_path_takes_no_checkpoints():
    """Under no_grad, or with no input that requires grad, the entry is one
    forward call without checkpoints; while autograd records, one with."""
    r, k, v, w, u, s0, _, _ = (torch.from_numpy(x)
                               for x in _inputs(1, 9, 2, 8, 3))
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("checkpoints", False))
        return kernel.wkv6_fwd(*args, **kw)

    held = u.clone().requires_grad_(True)
    with mock.patch.object(ops, "wkv6_fwd", spy):
        ops.wkv6(r, k, v, w, u, s0)
        with torch.no_grad():
            y, _ = ops.wkv6(r, k, v, w, held, s0)
        assert y.grad_fn is None
        y, _ = ops.wkv6(r, k, v, w, held, s0)
    assert calls == [False, False, True]
    assert y.grad_fn is not None


@pytest.mark.parametrize("impl", rwkv6.TIME_MIX_IMPLS)
def test_time_mix_gradients_match_reference(impl):
    """The port's time-mix (token shift, ``_ddlerp``, the decay LoRA, the
    WKV through the Function, the group norm and the output projection)
    differentiated by autograd, against ``jax.vjp`` of the reference's
    ``rwkv_time_forward`` in its ``scan`` form, float32, on rwkv6-7b's
    smoke layer 0 with a nonzero state: the gradients of every time-mix
    leaf, of x and of the incoming WKV state, each within 1e-4 of its max
    |value|, with one backward call of the WKV."""
    ref_cfg = ref_get_config("rwkv6-7b", smoke=True).replace(
        param_dtype="float32", activ_dtype="float32", time_mix_impl="scan")
    cfg = get_config("rwkv6-7b", smoke=True).replace(
        param_dtype="float32", activ_dtype="float32", time_mix_impl=impl)
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], ref_params["layers"]["time"])
    p = T._layer(params_from_numpy(jax.tree.map(np.asarray, ref_params))
                 ["layers"], 0)["time"]
    B, S, d = 2, 24, cfg.d_model
    H, n = cfg.n_heads, cfg.head_dim
    rng = np.random.default_rng(34)
    x, tm_x, s0, dout, dS = (rng.standard_normal(s).astype(np.float32) * c
                             for s, c in (((B, S, d), 1.0), ((B, d), 1.0),
                                          ((B, H, n, n), 0.3),
                                          ((B, S, d), 1.0), ((B, H, n, n),
                                                             1.0)))

    def ref_fn(tree, xx, ss):
        out, new = ref_rwkv6.rwkv_time_forward(
            tree, ref_cfg, xx, {"tm_x": jnp.asarray(tm_x), "wkv": ss})
        return out, new["wkv"]

    want_p, want_x, want_s = jax.jit(lambda a, b_, c, ct: jax.vjp(
        ref_fn, a, b_, c)[1](ct))(jp, jnp.asarray(x), jnp.asarray(s0),
                                  (jnp.asarray(dout), jnp.asarray(dS)))
    names = sorted(p)
    held = {name: p[name].detach().clone().requires_grad_(True)
            for name in names}
    hx = torch.from_numpy(x).requires_grad_(True)
    hs = torch.from_numpy(s0).requires_grad_(True)
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return kernel.wkv6_bwd(*args, **kw)

    with mock.patch.object(ops, "wkv6_bwd", spy):
        out, new = rwkv6.rwkv_time_forward(
            held, cfg, hx, {"tm_x": torch.from_numpy(tm_x), "wkv": hs})
        got = torch.autograd.grad(
            (out, new["wkv"]), [held[name] for name in names] + [hx, hs],
            (torch.from_numpy(dout), torch.from_numpy(dS)))
    assert calls == [1]
    wants = [want_p[name] for name in names] + [want_x, want_s]
    for name, g, w in zip(names + ["x", "s0"], got, wants):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= MODEL_TOL * float(np.abs(w).max()), (name, err)

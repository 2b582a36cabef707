"""The port's trainer against the reference's ``launch/train.py``.

On the CPU, at smoke sizes, with the reference's weights carried into the
port (``params_from_numpy``) and inputs drawn with numpy from a seed:

* ``model_loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's, for every ``attn``-block family, in float32 (the loss within
  1e-5 relative, each leaf's max |difference| within 1e-4 of its max
  |gradient|) and bf16 (the loss within 2e-2 absolute, each leaf's
  difference within 5% of its norm: the frameworks round to bf16 at
  different points; 30% for deepseek-v2-236b, whose MoE router sends a
  token to another expert where its bf16 input differs in the last bit at
  a near-tie of its top-k, 8 experts at the smoke width);
* every ``remat_policy`` giving bit-equal gradients (hymba-1.5b's scan
  and rwkv6-7b's WKV through their Functions, recomputed under
  checkpointing);
* hymba-1.5b's and rwkv6-7b's smoke training losses against the
  reference's ``train()`` (bf16, within 3e-2 absolute), and hymba-1.5b's
  ``ssm`` leaves' first-step gradients against ``jax.value_and_grad``
  (float32, 1e-4 of each leaf's max |gradient|);
* ``TokenPipeline`` batches bit-identical;
* ``make_train_step`` at ``grad_accum`` 1 and 2 after 3 steps (float32:
  parameters within 1e-4 of each leaf's max |value| plus 1% of the
  learning rate, since AdamW's normalised step turns a rounding of a
  gradient near 0 into a change of up to the learning rate; losses and
  grad norms within 1e-5 relative);
* ``train()``'s losses against the reference's ``train()`` (its bf16 smoke
  config: within 3e-2 absolute at losses near 6);
* a 20-step run killed at its step-10 checkpoint and resumed, repeating
  exactly (port only), and a checkpoint of either package resumed by the
  other (bf16 tolerance as above).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as par  # noqa: E402
from repro.data.tokens import TokenPipeline as RefTokenPipeline  # noqa: E402
from repro.data.tokens import (  # noqa: E402
    TokenPipelineConfig as RefTokenPipelineConfig)
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.data.tokens import (TokenPipeline,  # noqa: E402
                                     TokenPipelineConfig)
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ATTN_FAMILIES = ["gemma3-1b", "granite-3-8b", "dbrx-132b",
                 "deepseek-v2-236b", "internvl2-26b", "musicgen-large"]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # relative / absolute
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.05}
BF16_MOE_ROUTING_TOL = {"deepseek-v2-236b": 0.3}
TRAIN_LOSS_ATOL = 3e-2


def _batch(cfg, B, S, seed=0):
    """(reference batch, port batch): tokens, with patch embeddings for
    vision, or frames and codebook labels for audio."""
    ref_b, b = par.batches(cfg, B, S, seed)
    if cfg.frontend == "audio":
        labels = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab_size, (B, S, cfg.n_codebooks)).astype(np.int32)
        ref_b["labels"], b["labels"] = jnp.asarray(labels), \
            torch.from_numpy(labels)
    return ref_b, b


def _grads_close(got, want, tol, dtype):
    """float32: each leaf's max |difference| within ``tol`` of its max
    |value|; bf16: each leaf's difference within ``tol`` of its norm."""
    g_leaves = adamw.tree_leaves(got)
    w_leaves = [np.asarray(w, np.float32)
                for w in jax.tree_util.tree_leaves(want)]
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape
        d = g.float().numpy() - w
        if dtype == "float32":
            err, scale = float(np.abs(d).max()), float(np.abs(w).max())
        else:
            err, scale = float(np.linalg.norm(d)), float(np.linalg.norm(w))
        assert err <= tol * scale, (tuple(g.shape), err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ATTN_FAMILIES)
def test_model_loss_and_grads_match_reference(arch, dtype):
    c = par.carry(arch, dtype)
    ref_b, b = _batch(c.cfg, 2, 24)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_T.model_loss(p, c.ref_cfg, ref_b)))(c.ref_params)
    loss, grads = steps._loss_and_grads(c.cfg, c.params, b)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(want),
                                   rtol=LOSS_TOL[dtype])
    else:
        assert abs(float(loss) - float(want)) <= LOSS_TOL[dtype]
    tol = GRAD_TOL[dtype]
    if dtype == "bfloat16":
        tol = BF16_MOE_ROUTING_TOL.get(arch, tol)
    _grads_close(grads, want_g, tol, dtype)


@pytest.mark.parametrize("arch", ["gemma3-1b", "dbrx-132b",
                                  "deepseek-v2-236b", "internvl2-26b",
                                  "hymba-1.5b", "rwkv6-7b"])
def test_every_remat_policy_gives_equal_gradients(arch):
    c = par.carry(arch, "float32")
    _, b = _batch(c.cfg, 2, 16)
    runs = {pol: steps._loss_and_grads(c.cfg.replace(remat_policy=pol),
                                       c.params, b)
            for pol in T.REMAT_POLICIES}
    loss, grads = runs["none"]
    for pol, (l2, g2) in runs.items():
        assert torch.equal(l2, loss), pol
        for a, b_ in zip(adamw.tree_leaves(grads), adamw.tree_leaves(g2)):
            assert torch.equal(a, b_), pol
    with pytest.raises(ValueError, match="remat_policy"):
        steps._loss_and_grads(c.cfg.replace(remat_policy="offload"),
                              c.params, b)


def test_chunked_vocab_loss_in_model_loss():
    c = par.carry("granite-3-8b", "float32", vocab_loss_chunk=64)
    ref_b, b = _batch(c.cfg, 2, 12)
    want = ref_T.model_loss(c.ref_params, c.ref_cfg, ref_b)
    loss, _ = steps._loss_and_grads(c.cfg, c.params, b)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


@pytest.mark.parametrize("step,offset,bs", [(0, 0, None), (7, 0, 3),
                                            (123, 2, 5)])
def test_token_pipeline_is_bit_identical(step, offset, bs):
    kw = dict(vocab_size=517, seq_len=33, global_batch=6, seed=11)
    ref = RefTokenPipeline(RefTokenPipelineConfig(**kw))
    got = TokenPipeline(TokenPipelineConfig(**kw))
    np.testing.assert_array_equal(got.perms, ref.perms)
    a, b = got.batch(step, bs, offset), ref.batch(step, bs, offset)
    assert a["tokens"].dtype == np.int32
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    it, ref_it = iter(got), iter(ref)
    for _ in range(2):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      next(ref_it)["tokens"])


@pytest.mark.parametrize("arch,accum", [("gemma3-1b", 1), ("gemma3-1b", 2),
                                        ("dbrx-132b", 2)])
def test_train_step_matches_reference_after_three_steps(arch, accum):
    c = par.carry(arch, "float32")
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    ref_step = jax.jit(ref_steps.make_train_step(
        c.ref_cfg, ref_adamw.AdamWConfig(**kw), accum))
    step = steps.make_train_step(c.cfg, adamw.AdamWConfig(**kw), accum)
    ref_p, p = c.ref_params, c.params
    ref_s, s = ref_adamw.init_opt_state(ref_p), adamw.init_opt_state(p)
    for i in range(3):
        ref_b, b = _batch(c.cfg, 4, 16, seed=i)
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s, ref_b)
        p, s, m = step(p, s, b)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(s.step) == 3
    for g, w in zip(adamw.tree_leaves(p), jax.tree_util.tree_leaves(ref_p)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=1e-4 * float(np.abs(w).max()) + 1e-2 * kw["lr"])


def test_grad_accum_splits_rows_as_the_reference():
    """Microbatch j holds rows j, j + accum, ...: the accumulated gradient
    is the mean of those microbatches' gradients, in that order."""
    c = par.carry("gemma3-1b", "float32")
    _, b = _batch(c.cfg, 4, 12)
    cfg = adamw.AdamWConfig(lr=0.0, weight_decay=0.0, clip_norm=0.0)
    _, _, m = steps.make_train_step(c.cfg, cfg, 2)(
        c.params, adamw.init_opt_state(c.params), b)
    l0, g0 = steps._loss_and_grads(c.cfg, c.params,
                                   {"tokens": b["tokens"][0::2]})
    l1, g1 = steps._loss_and_grads(c.cfg, c.params,
                                   {"tokens": b["tokens"][1::2]})
    assert torch.equal(m["loss"], (torch.zeros(()) + l0 + l1) / 2)
    want = adamw.global_norm(adamw.tree_map(
        lambda a, b_: (torch.zeros_like(a) + a + b_) / 2, g0, g1))
    torch.testing.assert_close(m["grad_norm"], want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(c.cfg, cfg, 3)(
            c.params, adamw.init_opt_state(c.params), b)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_recurrent_blocks_train_on_the_cpu(arch):
    """Their plain versions differentiate on the CPU (hymba-1.5b's scan
    through the selective-scan Function's plain backward, rwkv6-7b's WKV
    through the wkv6 Function's)."""
    c = par.carry(arch, "float32")
    _, b = _batch(c.cfg, 2, 12)
    step = steps.make_train_step(c.cfg, adamw.AdamWConfig(lr=1e-3))
    p, s, m = step(c.params, adamw.init_opt_state(c.params), b)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(torch.isfinite(x).all() for x in adamw.tree_leaves(p))


def _carried_smoke_params(arch, seed=0):
    """The reference's own draw for ``train(arch, seed=seed)`` (its smoke
    config, bf16), as the port's tensors."""
    cfg = ref_train.get_config(arch, smoke=True)
    return params_from_numpy(jax.tree.map(
        np.asarray, ref_T.init_params(cfg, jax.random.PRNGKey(seed))))


def test_train_losses_match_reference():
    kw = dict(steps=6, smoke=True, batch=4, seq=32, lr=3e-3, log_every=100)
    want = ref_train.train("gemma3-1b", **kw)
    got = train.train("gemma3-1b", device="cpu",
                      params=_carried_smoke_params("gemma3-1b"), **kw)
    assert len(got["loss"]) == 6 and got["replans"] == want["replans"] == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=TRAIN_LOSS_ATOL)


def test_train_losses_match_reference_hymba():
    """hymba-1.5b's smoke config (bf16) trained 6 steps by both packages
    from the reference's draw: the scan's gradient comes from the
    selective-scan Function's plain backward here, from jax's autodiff of
    its ``lax.scan`` there."""
    kw = dict(steps=6, smoke=True, batch=4, seq=32, lr=3e-3, log_every=100)
    want = ref_train.train("hymba-1.5b", **kw)
    got = train.train("hymba-1.5b", device="cpu",
                      params=_carried_smoke_params("hymba-1.5b"), **kw)
    assert len(got["loss"]) == 6 and got["replans"] == want["replans"] == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=TRAIN_LOSS_ATOL)


def test_train_losses_match_reference_rwkv():
    """rwkv6-7b's smoke config (bf16) trained 6 steps by both packages from
    the reference's draw: the WKV's gradient comes from the wkv6
    Function's plain backward here, from jax's autodiff of its
    ``lax.scan`` there."""
    kw = dict(steps=6, smoke=True, batch=4, seq=32, lr=3e-3, log_every=100)
    want = ref_train.train("rwkv6-7b", **kw)
    got = train.train("rwkv6-7b", device="cpu",
                      params=_carried_smoke_params("rwkv6-7b"), **kw)
    assert len(got["loss"]) == 6 and got["replans"] == want["replans"] == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=TRAIN_LOSS_ATOL)


def test_ssm_gradients_match_reference():
    """hymba-1.5b's first-step gradients of every ``ssm`` leaf (float32)
    against ``jax.value_and_grad`` of the reference's ``model_loss``: each
    leaf's max |difference| within ``GRAD_TOL["float32"]`` of its max
    |gradient|, and the loss within 1e-5 relative."""
    c = par.carry("hymba-1.5b", "float32")
    ref_b, b = _batch(c.cfg, 2, 24)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_T.model_loss(p, c.ref_cfg, ref_b)))(c.ref_params)
    loss, grads = steps._loss_and_grads(c.cfg, c.params, b)
    np.testing.assert_allclose(float(loss), float(want),
                               rtol=LOSS_TOL["float32"])
    got, ref = grads["layers"]["ssm"], want_g["layers"]["ssm"]
    assert sorted(got) == sorted(ref)
    for key in sorted(got):
        w = np.asarray(ref[key], np.float32)
        g = got[key].numpy()
        assert g.shape == w.shape, key
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= GRAD_TOL["float32"] * scale, (key, err, scale)


def test_train_straggler_replans_as_the_reference(capsys):
    from repro.distributed.fault import FaultEvent as RefFaultEvent
    from repro.distributed.fault import FaultPlan as RefFaultPlan
    from repro_torch.distributed.fault import FaultEvent, FaultPlan
    from repro_torch.core.hetero import HeterogeneityProfile
    from repro.core.hetero import HeterogeneityProfile as RefProfile
    kw = dict(steps=3, smoke=True, batch=4, seq=16, log_every=100)
    want = ref_train.train(
        "gemma3-1b", profile=RefProfile.homogeneous(2),
        fault_plan=RefFaultPlan([RefFaultEvent(1, "straggler", 1, 4.0)]),
        **kw)
    ref_out = capsys.readouterr().out
    got = train.train(
        "gemma3-1b", device="cpu", profile=HeterogeneityProfile.homogeneous(2),
        fault_plan=FaultPlan([FaultEvent(1, "straggler", 1, 4.0)]), **kw)
    out = capsys.readouterr().out
    assert got["replans"] == want["replans"] == 1
    fault = [line for line in out.splitlines() if line.startswith("[fault]")]
    assert fault == [line for line in ref_out.splitlines()
                     if line.startswith("[fault]")]


def test_train_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("gemma3-1b", steps=1)


def _kill_at(ckpt_dir, step):
    """Leave only the step-``step`` checkpoint, as a run killed after it."""
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name != f"step_{step:09d}":
            shutil.rmtree(os.path.join(ckpt_dir, name))
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(f"step_{step:09d}")


def test_checkpoint_kill_and_resume_repeats_exactly(tmp_path):
    kw = dict(steps=20, smoke=True, batch=4, seq=32, lr=1e-3,
              log_every=100, device="cpu")
    d = str(tmp_path / "ck")
    h1 = train.train("granite-3-8b", ckpt_dir=d, ckpt_every=10, **kw)
    _kill_at(d, 10)
    h2 = train.train("granite-3-8b", ckpt_dir=d, ckpt_every=50,
                     restore=True, **kw)
    assert len(h2["loss"]) == 10
    assert h2["loss"] == h1["loss"][10:]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_the_packages(tmp_path, writer):
    """A 10-step run of one package checkpoints at step 5 and is killed
    there; the other package resumes it, and its last 5 losses match the
    writer's uninterrupted run."""
    kw = dict(steps=10, smoke=True, batch=4, seq=16, lr=1e-3,
              log_every=100)
    d = str(tmp_path / "ck")
    if writer == "reference":
        h1 = ref_train.train("gemma3-1b", ckpt_dir=d, ckpt_every=5, **kw)
        _kill_at(d, 5)
        h2 = train.train("gemma3-1b", ckpt_dir=d, ckpt_every=50,
                         restore=True, device="cpu", **kw)
    else:
        h1 = train.train("gemma3-1b", ckpt_dir=d, ckpt_every=5,
                         device="cpu",
                         params=_carried_smoke_params("gemma3-1b"), **kw)
        _kill_at(d, 5)
        h2 = ref_train.train("gemma3-1b", ckpt_dir=d, ckpt_every=50,
                             restore=True, **kw)
    assert len(h2["loss"]) == 5
    np.testing.assert_allclose(h2["loss"], h1["loss"][5:], rtol=0,
                               atol=TRAIN_LOSS_ATOL)


def test_cli_trains_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "gemma3-1b", "--steps", "3", "--batch", "2",
        "--seq", "16", "--device", "cpu", "--inject-straggler", "1"])
    train.main()
    out = capsys.readouterr().out
    assert "[train] step     2" in out and "[fault] step 1" in out

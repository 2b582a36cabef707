"""The port's rule-match kernels, held bit-exact against the reference.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those versions, and the padding/variant dispatch of ``rule_topk``
around them, to the reference's jnp oracle and to its int8 Pallas kernel in
interpret mode.  Items and scores must be equal, ties included: the
reference orders the top-k by (score desc, item id asc).  The CUDA kernels
themselves are compared with the same plain versions on the card by
``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rule_match import ops as ref_ops  # noqa: E402
from repro.kernels.rule_match.kernel import rule_scores_pallas  # noqa: E402
from repro.kernels.rule_match.ref import recommend_ref  # noqa: E402
from repro.kernels.rule_match.ref import (  # noqa: E402
    rule_scores_ref as jnp_rule_scores_ref)
from repro_torch.kernels import loader  # noqa: E402
from repro_torch.kernels.rule_match import fused, kernel, ops  # noqa: E402
from repro_torch.kernels.rule_match.ref import (  # noqa: E402
    recommend_ref as torch_recommend_ref, rule_scores_ref)
from repro_torch.kernels.support_count.fused import pack_words  # noqa: E402

# name: (B, I, R, k, confidences drawn from {0.5, 1.0}).  B and I ragged,
# R ragged and empty, and a tie case whose k exceeds the positive scores,
# so equal scores and zeros both test the (score desc, item asc) order.
CASES = {
    "5x40x17": (5, 40, 17, 3, False),
    "5x40x0": (5, 40, 0, 4, False),
    "8x128x128": (8, 128, 128, 5, False),
    "12x64x150": (12, 64, 150, 4, False),
    "1x33x7": (1, 33, 7, 1, False),
    "ties": (5, 40, 17, 12, True),
}


@functools.cache
def _case(name):
    """Seeded numpy inputs: antecedents of 1-3 items, row 0 with |a| = 0
    (matches every basket) and row 1 with sizes = -1 (never matches)."""
    B, I, R, k, ties = CASES[name]
    rng = np.random.default_rng(sum(CASES[name][:4]))
    Q = (rng.random((B, I)) < 0.3).astype(np.uint8)
    A = np.zeros((R, I), np.uint8)
    for r in range(R):
        A[r, rng.choice(I, size=rng.integers(1, 4), replace=False)] = 1
    if R:
        A[0] = 0
    sizes = A.sum(1).astype(np.float32)
    if R > 1:
        sizes[1] = -1.0
    conf = (rng.choice(np.array([0.5, 1.0], np.float32), R) if ties
            else rng.random(R).astype(np.float32))
    cons = rng.integers(0, I, R).astype(np.int32)
    return Q, A, sizes, conf, cons, k


def _padded(name):
    """The case padded by hand as ``rule_topk`` pads it (B→8·, I→128·,
    R→128· with never-match rows), for the reference's raw kernels."""
    Q, A, sizes, conf, cons, _ = _case(name)
    (B, I), R = Q.shape, A.shape[0]
    Ip, Rp = I + (-I) % 128, max(R + (-R) % 128, 128)
    return (np.pad(Q, ((0, (-B) % 8), (0, Ip - I))),
            np.pad(A, ((0, Rp - R), (0, Ip - I))),
            np.pad(sizes, (0, Rp - R), constant_values=-1),
            np.pad(conf, (0, Rp - R)),
            np.pad(cons, (0, Rp - R), constant_values=Ip))


@functools.cache
def _reference_topk(name):
    """(items, scores) from the reference's jnp oracle on the hand-padded
    case, and from its rule_topk through the interpreted int8 kernel."""
    Q, A, sizes, conf, cons, k = _case(name)
    B, I = Q.shape
    Qp, Ap, sp, cp, consp = _padded(name)
    oracle = recommend_ref(jnp.asarray(Qp, jnp.int8),
                           jnp.asarray(Ap, jnp.int8), jnp.asarray(sp),
                           jnp.asarray(cp), jnp.asarray(consp), I, k)
    pallas = ref_ops.rule_topk(Q, A, sizes, conf, cons, k=k, n_items=I,
                               backend="pallas", interpret=True,
                               tuning={"variant": "mxu"})
    return ([np.asarray(x)[:B] for x in oracle],
            [np.asarray(x) for x in pallas])


def _tensors(name):
    Q, A, sizes, conf, cons, k = _case(name)
    return [torch.from_numpy(x) for x in (Q, A, sizes, conf, cons)] + [k]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_scores_match_reference(name):
    """Both plain kernel versions and the port's oracle equal the
    reference's jnp scores and its int8 Pallas kernel (interpreted)."""
    Qp, Ap, sp, cp, _ = _padded(name)
    want = np.asarray(jnp_rule_scores_ref(jnp.asarray(Qp), jnp.asarray(Ap),
                                          jnp.asarray(sp), jnp.asarray(cp)))
    pallas = np.asarray(rule_scores_pallas(
        jnp.asarray(Qp, jnp.int8), jnp.asarray(Ap, jnp.int8),
        jnp.asarray(sp)[None, :], jnp.asarray(cp)[None, :], interpret=True))
    np.testing.assert_array_equal(pallas, want)
    Q, A = torch.from_numpy(Qp).to(torch.int8), torch.from_numpy(Ap).to(
        torch.int8)
    s, c = torch.from_numpy(sp), torch.from_numpy(cp)
    got = {
        "packed": fused.rule_scores_packed_plain(
            pack_words(Q), pack_words(A), s.to(torch.int32), c),
        "int8": kernel.rule_scores_int8_plain(Q, A, s, c),
        "ref": rule_scores_ref(Q, A, s, c),
    }
    for variant, scores in got.items():
        assert scores.dtype == torch.float32, variant
        np.testing.assert_array_equal(scores.numpy(), want, err_msg=variant)
    if Ap.shape[0] and _case(name)[1].shape[0]:
        assert (want[:, 0] == cp[0]).all()       # |a| = 0 matches everyone
    if _case(name)[1].shape[0] > 1:
        assert (want[:, 1] == 0).all()           # sizes = -1 never matches
    assert (want[:, len(_case(name)[1]):] == 0).all()   # padding rows


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("backend,tuning",
                         [("ref", None), ("cuda", None),
                          ("cuda", {"variant": "mxu"})],
                         ids=["ref", "packed", "mxu"])
def test_rule_topk_matches_reference(name, backend, tuning):
    Q, A, sizes, conf, cons, k = _tensors(name)
    (B, I) = Q.shape
    items, scores = ops.rule_topk(Q, A, sizes, conf, cons, k=k, n_items=I,
                                  backend=backend, tuning=tuning)
    assert items.dtype == torch.int32 and scores.dtype == torch.float32
    assert items.shape == scores.shape == (B, k)
    (want_i, want_s), (pal_i, pal_s) = _reference_topk(name)
    for ref_items, ref_scores in ((want_i, want_s), (pal_i, pal_s)):
        np.testing.assert_array_equal(items.numpy(), ref_items)
        np.testing.assert_array_equal(scores.numpy(), ref_scores)


def test_tie_case_exercises_the_order():
    """The tie case really has equal positive scores and more slots than
    positive scores in some row, so the order of equals is tested."""
    (want_i, want_s), _ = _reference_topk("ties")
    k = CASES["ties"][3]
    assert any(len(set(row[row > 0])) < (row > 0).sum() for row in want_s)
    assert any((row > 0).sum() < k for row in want_s)
    for items, scores in zip(want_i, want_s):
        keys = [(-s, i) for i, s in zip(items, scores)]
        assert keys == sorted(keys)


def test_full_oracle_equals_reference_oracle():
    Qp, Ap, sp, cp, consp = _padded("ties")
    k, I = CASES["ties"][3], CASES["ties"][1]
    got = torch_recommend_ref(*(torch.from_numpy(x) for x in
                                (Qp, Ap, sp, cp, consp)), I, k)
    want = recommend_ref(*(jnp.asarray(x) for x in (Qp, Ap, sp, cp, consp)),
                         I, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_wrappers_run_plain_versions_without_counting_launches():
    Qp, Ap, sp, cp, _ = _padded("8x128x128")
    Q, A = torch.from_numpy(Qp).to(torch.int8), torch.from_numpy(Ap).to(
        torch.int8)
    s, c = torch.from_numpy(sp), torch.from_numpy(cp)
    before = (fused.rule_scores_packed.launches,
              kernel.rule_scores_int8.launches)
    a = fused.rule_scores_packed(pack_words(Q), pack_words(A),
                                 s.to(torch.int32), c)
    b = kernel.rule_scores_int8(Q, A, s, c)
    assert torch.equal(a, b) and torch.equal(a, rule_scores_ref(Q, A, s, c))
    assert (fused.rule_scores_packed.launches,
            kernel.rule_scores_int8.launches) == before


def test_plain_packed_chunks_over_rules(monkeypatch):
    """The plain packed version walks R in slices; a slice boundary inside
    R must not change a score."""
    Qp, Ap, sp, cp, _ = _padded("12x64x150")
    monkeypatch.setattr(fused, "_PLAIN_CHUNK_BYTES", 16 * 4 * 8 * 10)
    Q, A = torch.from_numpy(Qp), torch.from_numpy(Ap)
    s, c = torch.from_numpy(sp), torch.from_numpy(cp)
    got = fused.rule_scores_packed_plain(pack_words(Q), pack_words(A),
                                         s.to(torch.int32), c)
    assert torch.equal(got, rule_scores_ref(Q, A, s, c))


def test_wrappers_and_rule_topk_reject_bad_inputs():
    w = torch.zeros((4, 2), dtype=torch.int32)
    f = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(TypeError):
        fused.rule_scores_packed(w, w, f, f)            # sizes must be int32
    with pytest.raises(ValueError):
        fused.rule_scores_packed(w, w, f.to(torch.int32)[:3], f)
    b = torch.zeros((4, 64), dtype=torch.int8)
    with pytest.raises(TypeError):
        kernel.rule_scores_int8(b, b, f.to(torch.int32), f)
    with pytest.raises(ValueError):
        kernel.rule_scores_int8(b, b[:, :32], f, f)
    # a device that is neither the CPU nor a card has no kernel and no
    # plain fallback
    meta = [x.to("meta") for x in (b, b, f, f)]
    with pytest.raises(ValueError):
        kernel.rule_scores_int8(*meta)
    Q, A, sizes, conf, cons, _ = _tensors("5x40x17")
    # the reference's own checks, with its own exception types
    for kw in (dict(k=0, n_items=40), dict(k=41, n_items=40),
               dict(k=3, n_items=41)):
        with pytest.raises(ValueError):
            ref_ops.rule_topk(Q.numpy(), A.numpy(), sizes.numpy(),
                              conf.numpy(), cons.numpy(), backend="ref", **kw)
        with pytest.raises(ValueError):
            ops.rule_topk(Q, A, sizes, conf, cons, **kw)
    with pytest.raises(ValueError):
        ops.rule_topk(Q, A[:, :32], sizes, conf, cons, k=3, n_items=32)
    with pytest.raises(ValueError):
        ops.rule_topk(Q, A, sizes, conf, cons, k=3, n_items=40,
                      backend="pallas")
    with pytest.raises(ValueError):
        ops.rule_topk(Q, A, sizes, conf, cons, k=3, n_items=40,
                      tuning={"variant": "bogus"})


def test_loader_knows_the_rule_match_sources():
    names = ("rule_match_packed", "rule_match_int8")
    paths = {loader.library_path(n) for n in names}
    assert len(paths) == 2
    for name in names:
        assert (loader.CSRC / f"{name}.cu").is_file()
        assert loader.library_path(name).parent == loader.BUILD_DIR


# (B, R, I) -> the launch geometry the int8 kernel takes on 132 SMs, and
# its CTA count: the serving shape at bucket 64 puts the queries on M
# against 32-rule tiles, split over clusters of 4; bucket 8 puts the rules
# on M and splits each 64-rule tile's items over a cluster of 8; the wide
# index takes 128-rule tiles in one wave; a 64-query batch goes back to
# the rules on M once its 32-rule tiles overfill a wave; small and ragged
# shapes take what their slabs allow
GEOMETRIES = {
    (64, 896, 1024): (kernel.Geometry(1, 32, 4, False), 112),
    (8, 896, 1024): (kernel.Geometry(1, 8, 8), 112),
    (64, 16384, 1024): (kernel.Geometry(2, 64, 1), 128),
    (64, 4224, 1024): (kernel.Geometry(1, 32, 1, False), 132),
    (64, 4225, 1024): (kernel.Geometry(1, 64, 1), 67),
    (1, 1, 64): (kernel.Geometry(1, 8, 1), 1),
    (5, 127, 192): (kernel.Geometry(1, 8, 2), 4),
    (9, 129, 64): (kernel.Geometry(1, 16, 1), 3),
    (65, 333, 1024): (kernel.Geometry(1, 32, 4, False), 88),
    (32, 4096, 4096): (kernel.Geometry(1, 32, 2), 128),
}


@pytest.mark.parametrize("shape", list(GEOMETRIES), ids=str)
def test_int8_launch_geometry(shape):
    want, ctas = GEOMETRIES[shape]
    geom = kernel.geometry(*shape)
    assert geom == want
    assert f"= {ctas} CTAs" in geom.describe(*shape)


@pytest.mark.parametrize("sms", [8, 132])
def test_int8_geometry_fills_one_wave_without_empty_slabs(sms):
    """Over ragged shapes: the queries are on M exactly when the batch is
    over 32 and their 32-rule tiles fit in one wave; with the rules on M,
    N covers the batch (or is 64); a cluster never has more CTAs than the
    item axis has 128-item slabs, and a split item axis never overfills
    one wave."""
    for B in (1, 7, 8, 9, 31, 33, 64, 65, 200):
        for R in (1, 64, 127, 896, 5000, 16384):
            for I in (64, 128, 192, 1024):
                g = kernel.geometry(B, R, I, sms)
                q_tiles = -(-R // kernel.RULE_TILE) * -(-B // 64)
                assert g.rules_on_m == (B <= 32 or q_tiles > sms)
                if g.rules_on_m:
                    assert g.n in kernel.QUERY_TILES
                    assert g.n >= min(B, 64)
                    tiles = -(-R // (64 * g.warpgroups)) * -(-B // g.n)
                    assert g.warpgroups == (2 if -(-R // 64) * -(-B // g.n)
                                            > sms else 1)
                else:
                    assert (g.warpgroups, g.n) == (1, kernel.RULE_TILE)
                    tiles = q_tiles
                assert g.cluster in kernel.CLUSTERS
                assert g.cluster <= -(-I // kernel.SLAB)
                assert g.cluster == 1 or tiles * g.cluster <= sms


# (B, R, W) -> the packed kernel's launch on 132 SMs and its CTA count:
# the rules on M at both serving buckets and for the wide index (one
# slab a row, no cluster); longer rows split over a cluster that divides
# their slabs while the CTAs fit in one wave
PACKED_GEOMETRIES = {
    (64, 896, 32): (fused.Geometry(64, 1), 14),
    (8, 896, 32): (fused.Geometry(8, 1), 14),
    (64, 16384, 32): (fused.Geometry(64, 1), 256),
    (5, 333, 240): (fused.Geometry(8, 8), 48),
    (17, 333, 48): (fused.Geometry(32, 2), 12),
    (37, 333, 96): (fused.Geometry(64, 1), 6),
    (65, 4000, 64): (fused.Geometry(64, 1), 126),
}


@pytest.mark.parametrize("shape", list(PACKED_GEOMETRIES), ids=str)
def test_packed_launch_geometry(shape):
    want, ctas = PACKED_GEOMETRIES[shape]
    geom = fused.geometry(*shape)
    assert geom == want
    assert f"= {ctas} CTAs" in geom.describe(shape[0], shape[1])


@pytest.mark.parametrize("sms", [8, 132])
def test_packed_geometry_fits(sms):
    """Over ragged shapes: N covering the batch (or 64), a cluster that
    divides the row's 128-byte slabs and, above 1, keeps one wave."""
    for B in (1, 7, 8, 9, 31, 33, 64, 65, 200):
        for R in (1, 64, 127, 896, 5000, 16384):
            for W in (4, 12, 32, 36, 64, 96, 256):
                g = fused.geometry(B, R, W, sms)
                assert g.n in kernel.QUERY_TILES and g.n >= min(B, 64)
                assert g.n == 8 or g.n // 2 < min(B, 64)
                slabs = -(-4 * W // kernel.SLAB)
                assert g.cluster in kernel.CLUSTERS
                assert slabs % g.cluster == 0
                tiles = -(-R // 64) * -(-B // g.n)
                assert g.cluster == 1 or tiles * g.cluster <= sms


def test_packed_kernel_layout_checks():
    """What the CUDA kernel asks beyond shapes and types, checked before a
    launch: W % 4 == 0, and contiguous 16-byte-aligned tensors (sizes
    and conf too: the epilogue reads them four at a time)."""
    Qw = torch.zeros((8, 32), dtype=torch.int32)
    Aw = torch.zeros((64, 32), dtype=torch.int32)
    sizes = torch.zeros(64, dtype=torch.int32)
    conf = torch.zeros(64)
    fused.check_kernel_layout(Qw, Aw, sizes, conf)
    with pytest.raises(ValueError, match="W % 4"):
        fused.check_kernel_layout(Qw[:, :30], Aw[:, :30], sizes, conf)
    with pytest.raises(ValueError, match="aligned"):
        fused.check_kernel_layout(Qw, Aw, torch.zeros(65, dtype=torch.int32)
                                  [1:], conf)
    with pytest.raises(ValueError, match="aligned"):
        fused.check_kernel_layout(Qw, Aw, sizes, torch.zeros(65)[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused.check_kernel_layout(Qw, Aw.t().contiguous().t(), sizes, conf)

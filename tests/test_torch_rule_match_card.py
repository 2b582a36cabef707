"""The port's rule-match kernels on the card (int8, and packed bits on the
binary tensor cores), against their plain versions.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference, so they run on a
machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rule_match_card.py

The function is exact (an integer dot compared with integral sizes), so
each kernel must equal its plain version (``rule_scores_int8_plain``,
``rule_scores_packed_plain``) bit for bit.  Inputs are
drawn with numpy from a seed: baskets of density 0.3, antecedents of 1-3
random items (one empty antecedent, which every basket matches) and
random confidences.  Each call must add exactly one launch.  The launch
geometry is the wrapper's own choice, so the shapes are picked to reach
every geometry it can take (a CPU test checks that they do).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rule_match import fused, kernel  # noqa: E402
from repro_torch.kernels.support_count.fused import pack_words  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(B, R, I, seed, device):
    rng = np.random.default_rng(seed)
    Q = (rng.random((B, I)) < 0.3).astype(np.int8)
    A = np.zeros((R, I), np.int8)
    cols = rng.integers(0, I, (R, 3))
    keep = np.arange(3)[None, :] < rng.integers(1, 4, (R, 1))
    A[np.repeat(np.arange(R)[:, None], 3, 1)[keep], cols[keep]] = 1
    A[0] = 0
    sizes = A.sum(1).astype(np.float32)
    conf = rng.random(R).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (Q, A, sizes, conf)]


def _held(Q, A, sizes, conf):
    launches = kernel.rule_scores_int8.launches
    got = kernel.rule_scores_int8(Q, A, sizes, conf)
    want = kernel.rule_scores_int8_plain(Q, A, sizes, conf)
    torch.cuda.synchronize()
    assert kernel.rule_scores_int8.launches == launches + 1
    assert torch.equal(got, want)
    return want


# (B, R, I): the serving shape at buckets 8 and 64 (an index of 896 rules
# over 1,024 lanes); item axes of one slab and of one and a half (I = 64,
# 192); ragged batches across the query tiles (1, 5, 9, 65); ragged rule
# counts across the 64-rule tiles (1, 127, 129, 333); a wide index
CARD_CASES = ([(8, 896, 1024), (64, 896, 1024), (64, 896, 64),
               (64, 896, 192)]
              + [(B, 333, 1024) for B in (1, 5, 9, 65)]
              + [(64, R, 1024) for R in (1, 127, 129, 333)]
              + [(64, 16_384, 1024)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,I", CARD_CASES)
def test_int8_kernel_equals_plain_version_on_the_card(card, B, R, I):
    want = _held(*_inputs(B, R, I, B + R + I, card))
    assert (want > 0).any()


@pytest.mark.cuda
def test_int8_kernel_padding_rows_never_match(card):
    Q = _inputs(8, 1, 1024, 0, card)[0]
    A = torch.zeros((128, 1024), dtype=torch.int8, device=card)
    sizes = torch.full((128,), -1.0, device=card)
    want = _held(Q, A, sizes, torch.ones(128, device=card))
    assert not want.any()


# every launch geometry that kernel.geometry can pick: the queries on M
# with each cluster; the rules on M with one warpgroup, N of 8, 16 or 32
# and each cluster, or N = 64 (the 32-rule tiles of a batch over 32
# overfill a wave, so 64-rule tiles leave no room for a cluster); two
# warpgroups (64-rule tiles above one wave) with each N
REACHABLE = ([kernel.Geometry(1, kernel.RULE_TILE, c, False)
              for c in kernel.CLUSTERS]
             + [kernel.Geometry(1, n, c) for n in kernel.QUERY_TILES[:-1]
                for c in kernel.CLUSTERS]
             + [kernel.Geometry(1, 64, 1)]
             + [kernel.Geometry(2, n, 1) for n in kernel.QUERY_TILES])


def _shape_for(geom, sms):
    """A (B, R, I) for which kernel.geometry picks ``geom`` on ``sms``
    SMs, with ragged tiles on both operands and a half last slab: the
    batch just above the next smaller N (37 with the queries on M), 333
    rules (or one tile more than a wave: of 32 rules for N = 64, of 64
    rules for two warpgroups) and an item axis of as many slabs as the
    cluster has CTAs."""
    B = {8: 5, 16: 9, 32: 17, 64: 37}[geom.n if geom.rules_on_m else 64]
    if geom.warpgroups == 2:
        return B, 64 * (sms + 1) - 37, 960
    if geom.rules_on_m and geom.n == 64:
        return B, 32 * sms + 27, 960
    return B, 333, kernel.SLAB * geom.cluster - 64


def _geom_id(geom):
    return "{}-wg{}-n{}-cluster{}".format(
        "rules" if geom.rules_on_m else "queries", *geom[:3])


@pytest.mark.parametrize("sms", [114, kernel.H100_SMS])
@pytest.mark.parametrize("geom", REACHABLE, ids=_geom_id)
def test_every_reachable_geometry_has_a_shape(geom, sms):
    assert kernel.geometry(*_shape_for(geom, sms), sms) == geom


@pytest.mark.cuda
@pytest.mark.parametrize("geom", REACHABLE, ids=_geom_id)
def test_int8_kernel_equals_plain_version_at_every_geometry(card, geom):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shape = _shape_for(geom, sms)
    assert kernel.geometry(*shape, sms) == geom
    _held(*_inputs(*shape, 5, card))


# ---- the packed kernel: the same launch geometries on rows of 4W bytes --

def _packed_inputs(B, R, W, seed, device):
    """``_inputs`` over 32W items, packed into W words a row."""
    Q, A, sizes, conf = _inputs(B, R, 32 * W, seed, device)
    return pack_words(Q), pack_words(A), sizes.to(torch.int32), conf


def _held_packed(Qw, Aw, sizes, conf):
    launches = fused.rule_scores_packed.launches
    got = fused.rule_scores_packed(Qw, Aw, sizes, conf)
    want = fused.rule_scores_packed_plain(Qw, Aw, sizes, conf)
    torch.cuda.synchronize()
    assert fused.rule_scores_packed.launches == launches + 1
    assert torch.equal(got, want)
    return want


# (B, R, W): the serving shape at buckets 8 and 64 and the wide index (32
# words a row); ragged batches and rule counts as for the int8 kernel;
# rows of 4 and 12 words (less than a slab) and of 36 and 68 (a ragged
# last slab)
PACKED_CASES = ([(8, 896, 32), (64, 896, 32), (64, 16_384, 32)]
                + [(B, 333, 32) for B in (1, 5, 9, 65)]
                + [(64, R, 32) for R in (1, 127, 129, 333)]
                + [(64, 333, W) for W in (4, 12, 36, 68)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,W", PACKED_CASES)
def test_packed_kernel_equals_plain_version_on_the_card(card, B, R, W):
    want = _held_packed(*_packed_inputs(B, R, W, B + R + W, card))
    assert (want > 0).any()


@pytest.mark.cuda
def test_packed_kernel_padding_rows_never_match(card):
    Qw = _packed_inputs(8, 1, 32, 0, card)[0]
    Aw = torch.zeros((128, 32), dtype=torch.int32, device=card)
    sizes = torch.full((128,), -1, dtype=torch.int32, device=card)
    want = _held_packed(Qw, Aw, sizes, torch.ones(128, device=card))
    assert not want.any()


# every launch geometry that fused.geometry can pick: each N and each
# cluster
PACKED_REACHABLE = [fused.Geometry(n, c) for n in kernel.QUERY_TILES
                    for c in kernel.CLUSTERS]


def _packed_shape_for(geom, sms):
    """A (B, R, W) for which fused.geometry picks ``geom``: the batch just
    above the next smaller N, 333 rules (6 tiles) and a row of as many
    128-byte slabs as the cluster has CTAs, the last one half full."""
    B = {8: 5, 16: 9, 32: 17, 64: 37}[geom.n]
    return B, 333, 32 * geom.cluster - 16


def _packed_geom_id(geom):
    return "rules-wg1-n{}-cluster{}".format(*geom)


@pytest.mark.parametrize("sms", [114, kernel.H100_SMS])
@pytest.mark.parametrize("geom", PACKED_REACHABLE, ids=_packed_geom_id)
def test_every_reachable_geometry_has_a_packed_shape(geom, sms):
    assert fused.geometry(*_packed_shape_for(geom, sms), sms) == geom


@pytest.mark.cuda
@pytest.mark.parametrize("geom", PACKED_REACHABLE, ids=_packed_geom_id)
def test_packed_kernel_equals_plain_version_at_every_geometry(card, geom):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shape = _packed_shape_for(geom, sms)
    assert fused.geometry(*shape, sms) == geom
    _held_packed(*_packed_inputs(*shape, 5, card))

"""The port's support-count kernels on the card (int8, and packed bits on the
binary tensor cores), against their plain versions.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference, so they run on a
machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_support_count_card.py

Support counts are integers, so each kernel must equal its plain version
(``support_count_int8_plain``, ``support_count_packed_plain``) exactly.
Inputs are drawn with numpy from a seed: transactions of a given density
and candidates of 1-3 items (the first one empty, |c| = 0, which every
real transaction contains, and which the zero-filled rows past N must not
add to; the last one holding item 31, a word's sign bit).  The packed
kernel takes the same 0/1 rows packed 32 items to a word, the item axis
zero-padded to a multiple of 128 (zero items are inert), so an item axis
of 64 gives it rows of 4 words (16 bytes, a ragged slab).  Each call must
add exactly one launch.  The launch geometry is each wrapper's own
choice, so the shapes are picked to reach every geometry it can take (a
CPU test checks that they do).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.support_count import fused, kernel  # noqa: E402

# variant -> (wrapper, plain version, geometry of [N, row], row of I items)
VARIANTS = {
    "int8": (kernel.support_count_int8, kernel.support_count_int8_plain,
             kernel.geometry, lambda I: I),
    "packed": (fused.support_count_packed, fused.support_count_packed_plain,
               fused.geometry, lambda I: -(-I // 128) * 4),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _as_variant(variant, T, C):
    """The 0/1 int8 rows as the variant's kernel takes them."""
    if variant == "int8":
        return T, C
    pad = (-T.shape[1]) % 128
    return (fused.pack_words(torch.nn.functional.pad(T, (0, pad))),
            fused.pack_words(torch.nn.functional.pad(C, (0, pad))))


def _inputs(variant, N, M, I, seed, device, density=0.3):
    rng = np.random.default_rng(seed)
    T = (rng.random((N, I)) < density).astype(np.int8)
    C = np.zeros((M, I), np.int8)
    cols = rng.integers(0, I, (M, 3))
    keep = np.arange(3)[None, :] < rng.integers(1, 4, (M, 1))
    C[np.repeat(np.arange(M)[:, None], 3, 1)[keep], cols[keep]] = 1
    if M > 1:
        C[-1, 31] = 1                  # bit 31 of word 0
    C[0] = 0
    sizes = C.sum(1, dtype=np.int32)
    T, C, sizes = (torch.from_numpy(x).to(device) for x in (T, C, sizes))
    return (*_as_variant(variant, T, C), sizes)


def _held(variant, T, C, sizes):
    wrapper, plain = VARIANTS[variant][:2]
    launches = wrapper.launches
    got = wrapper(T, C, sizes)
    want = plain(T, C, sizes)
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 1
    assert torch.equal(got, want)
    return want


# (N, M, I, density): the dense mine's four counting rounds (one tile of
# 3,128 transactions against 2,176, 256 and 128 candidates); chip_smoke's
# ragged shapes; N not a multiple of the tile; M across the tile widths;
# an item axis of one slab and of one and a half (for the packed kernel,
# rows of 4 and 8 words); every item of every transaction set; the
# streaming delta phase's slabs (1 to 1,000 rows) against a tracked set
# of the dense corpus (2,560) and of a stationary stream (256)
CARD_CASES = [(3128, 2176, 1024, 0.05), (3128, 256, 1024, 0.05),
              (3128, 128, 1024, 0.05), (77, 200, 128, 0.5),
              (4133, 1, 256, 0.5), (1000, 257, 1024, 0.5),
              (65, 64, 64, 0.5), (129, 65, 192, 0.5), (3001, 129, 1024, 0.1),
              (1, 3, 64, 1.0), (1, 2560, 1024, 0.05), (5, 256, 1024, 0.05),
              (1000, 2560, 1024, 0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("N,M,I,density", CARD_CASES)
def test_support_count_equals_plain_version_on_the_card(card, variant, N, M,
                                                        I, density):
    want = _held(variant, *_inputs(variant, N, M, I, N + M + I, card,
                                   density))
    assert int(want[0]) == N               # |c| = 0: every transaction
    assert (want[1:] > 0).any() or M == 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_support_count_walks_past_the_grids_last_tile(card, variant):
    """More transaction tiles than a grid's 65,535 (of 128 transactions
    for the int8 kernel's two warpgroups; the packed kernel's geometry
    has each CTA walk 256 tiles of 64): a CTA walks several, and the
    empty candidate's count reaches N."""
    N = kernel.MAX_GRID_Y * 128 + 100
    _, C, sizes = _inputs(variant, 1, 3, 64, 1, card)
    # 537 MB of int8 transactions, or 134 MB of packed words (4 a row, bit
    # 31 set in about half), drawn on the card
    gen = torch.Generator(device=card).manual_seed(1)
    if variant == "int8":
        T = torch.randint(0, 2, (N, 64), generator=gen, device=card,
                          dtype=torch.int8)
    else:
        T = torch.randint(-2**31, 2**31, (N, 4), generator=gen,
                          device=card, dtype=torch.int32)
    geom = VARIANTS[variant][2](N, 3, T.shape[1])
    assert geom.warpgroups == 2 if variant == "int8" else geom.tiles > 1
    want = _held(variant, T, C, sizes)
    assert int(want[0]) == N


# every geometry each variant's geometry() can pick, by the fields that
# tell them apart: the int8 kernel's (warpgroups, N) with each tile width
# and one or two warpgroups; the packed kernel's (tiles a CTA, stages):
# one tile of one slab, one tile of two slabs, two and four tiles a CTA
REACHABLE = [("int8", (wg, n)) for wg in (1, 2) for n in kernel.TILE_WIDTHS]
REACHABLE += [("packed", key) for key in ((1, 1), (1, 2), (2, 2), (4, 2))]


def _shape_for(variant, key, sms):
    """An (N, M, I) for which the variant's geometry() picks ``key`` on
    ``sms`` SMs, ragged on every axis.  int8: M inside the tile width (37,
    100 or 200), an item axis of one and a half slabs; 300 transactions
    (five 64-row tiles, the last of 44) for the 64-wide tiles, enough
    64-row tiles to fill three quarters of a wave for the wider ones, and
    64 x sms + 37 transactions for two warpgroups.  packed: 37 candidates
    (one tile) over 300 transactions of 8 words (one slab) or 64 words
    (two), and enough transaction tiles (4 sms + 1, 12 sms + 1) that one
    a CTA would overfill 4 CTAs an SM, and two a CTA would too."""
    if variant == "packed":
        tiles, stages = key
        if tiles == 1:
            return 300, 37, 192 if stages == 1 else 2048
        return 64 * {2: 4, 4: 12}[tiles] * sms + 37, 37, 192
    warpgroups, n = key
    M = {64: 37, 128: 100, 256: 200}[n]
    if warpgroups == 2:
        return 64 * sms + 37, M, 192
    if n > 64:
        return 64 * -(-3 * sms // 4) - 27, M, 192
    return 300, M, 192


def _picks(variant, shape, sms):
    N, M, I = shape
    W = VARIANTS[variant][3](I)
    geom = VARIANTS[variant][2](N, M, W, sms)
    if variant == "packed":
        return geom.tiles, geom.stages(N, W)
    return geom.warpgroups, geom.n


def _geom_id(case):
    return "{}-{}x{}".format(case[0], *case[1])


@pytest.mark.parametrize("sms", [114, kernel.H100_SMS])
@pytest.mark.parametrize("case", REACHABLE, ids=_geom_id)
def test_every_reachable_support_count_geometry_has_a_shape(case, sms):
    variant, key = case
    assert _picks(variant, _shape_for(variant, key, sms), sms) == key


@pytest.mark.cuda
@pytest.mark.parametrize("case", REACHABLE, ids=_geom_id)
def test_support_count_equals_plain_version_at_every_geometry(card, case):
    variant, key = case
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shape = _shape_for(variant, key, sms)
    assert _picks(variant, shape, sms) == key
    want = _held(variant, *_inputs(variant, *shape, 5, card))
    assert int(want[0]) == shape[0]

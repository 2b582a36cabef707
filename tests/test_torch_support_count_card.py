"""The port's int8 support-count kernel on the card, against its plain
version.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference, so they run on a
machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_support_count_card.py

Support counts are integers, so the kernel must equal
``support_count_int8_plain`` exactly.  Inputs are drawn with numpy from a
seed: transactions of a given density and candidates of 1-3 items (the
first one empty, |c| = 0, which every real transaction contains, and
which the zero-filled rows past N must not add to).  Each call must add
exactly one launch.  The launch geometry is the wrapper's own choice, so
the shapes are picked to reach every geometry it can take (a CPU test
checks that they do).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.support_count import kernel  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(N, M, I, seed, device, density=0.3):
    rng = np.random.default_rng(seed)
    T = (rng.random((N, I)) < density).astype(np.int8)
    C = np.zeros((M, I), np.int8)
    cols = rng.integers(0, I, (M, 3))
    keep = np.arange(3)[None, :] < rng.integers(1, 4, (M, 1))
    C[np.repeat(np.arange(M)[:, None], 3, 1)[keep], cols[keep]] = 1
    C[0] = 0
    sizes = C.sum(1, dtype=np.int32)
    return [torch.from_numpy(x).to(device) for x in (T, C, sizes)]


def _held(T, C, sizes):
    launches = kernel.support_count_int8.launches
    got = kernel.support_count_int8(T, C, sizes)
    want = kernel.support_count_int8_plain(T, C, sizes)
    torch.cuda.synchronize()
    assert kernel.support_count_int8.launches == launches + 1
    assert torch.equal(got, want)
    return want


# (N, M, I, density): the dense mine's four counting rounds (one tile of
# 3,128 transactions against 2,176, 256 and 128 candidates); chip_smoke's
# ragged shapes; N not a multiple of the tile; M across the tile widths;
# an item axis of one slab and of one and a half
CARD_CASES = [(3128, 2176, 1024, 0.05), (3128, 256, 1024, 0.05),
              (3128, 128, 1024, 0.05), (77, 200, 128, 0.5),
              (4133, 1, 256, 0.5), (1000, 257, 1024, 0.5),
              (65, 64, 64, 0.5), (129, 65, 192, 0.5), (3001, 129, 1024, 0.1),
              (1, 3, 64, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,I,density", CARD_CASES)
def test_int8_support_count_equals_plain_version_on_the_card(card, N, M, I,
                                                             density):
    want = _held(*_inputs(N, M, I, N + M + I, card, density))
    assert int(want[0]) == N               # |c| = 0: every transaction
    assert (want[1:] > 0).any() or M == 1


@pytest.mark.cuda
def test_int8_support_count_walks_past_the_grids_last_tile(card):
    """More transaction tiles than a grid's 65,535: a CTA walks several,
    and the empty candidate's count reaches N."""
    N = kernel.MAX_GRID_Y * 128 + 100
    _, C, sizes = _inputs(1, 3, 64, 1, card)
    # 537 MB of transactions, drawn on the card
    gen = torch.Generator(device=card).manual_seed(1)
    T = torch.randint(0, 2, (N, 64), generator=gen, device=card,
                      dtype=torch.int8)
    assert kernel.geometry(N, 3, 64).warpgroups == 2
    want = _held(T, C, sizes)
    assert int(want[0]) == N


# every (warpgroups, N) that kernel.geometry can pick: one warpgroup with
# each tile width, and two warpgroups (64-row tiles above one wave) with
# each tile width
REACHABLE = [(wg, n) for wg in (1, 2) for n in kernel.TILE_WIDTHS]


def _shape_for(geom, sms):
    """An (N, M, I) for which kernel.geometry picks ``geom`` on ``sms``
    SMs, ragged on every axis: M inside the tile width (37, 100 or 200),
    an item axis of one and a half slabs; 300 transactions (five 64-row
    tiles, the last of 44) for the 64-wide tiles, enough 64-row tiles to
    fill three quarters of a wave for the wider ones, and 64 x sms + 37
    transactions for two warpgroups."""
    warpgroups, n = geom
    M = {64: 37, 128: 100, 256: 200}[n]
    if warpgroups == 2:
        return 64 * sms + 37, M, 192
    if n > 64:
        return 64 * -(-3 * sms // 4) - 27, M, 192
    return 300, M, 192


def _geom_id(geom):
    return "wg{}-n{}".format(*geom)


@pytest.mark.parametrize("sms", [114, kernel.H100_SMS])
@pytest.mark.parametrize("geom", REACHABLE, ids=_geom_id)
def test_every_reachable_support_count_geometry_has_a_shape(geom, sms):
    assert tuple(kernel.geometry(*_shape_for(geom, sms), sms))[:2] == geom


@pytest.mark.cuda
@pytest.mark.parametrize("geom", REACHABLE, ids=_geom_id)
def test_int8_support_count_equals_plain_version_at_every_geometry(card,
                                                                   geom):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shape = _shape_for(geom, sms)
    assert tuple(kernel.geometry(*shape, sms))[:2] == geom
    want = _held(*_inputs(*shape, 5, card))
    assert int(want[0]) == shape[0]

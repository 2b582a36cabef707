"""``density_stats`` — the measurement ``auto`` prices before it mines —
held field for field against the reference's on every input form.

The port counts a dense bool or uint8 bitmap in uint16 over blocks of 257
rows, on several threads for a large one, and widens only the partials;
the reference sums an int64 copy.  The counts must be equal, exactly, for
0/1 input, for bytes up to 255 (a block of 257 rows of 255 fills a uint16
exactly), for other integer types (the int64 sum) and for the CSR slab
and id-list forms.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data.sparse import SparseSlab as RefSlab  # noqa: E402
from repro.data.sparse import density_stats as ref_density_stats  # noqa: E402
from repro_torch.data import sparse  # noqa: E402
from repro_torch.data.sparse import (  # noqa: E402
    SparseSlab, dense_item_counts, density_stats)


def _bitmap(n_tx, n_items, p, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return (rng.random((n_tx, n_items)) < p).astype(dtype)


def _same(got, want):
    assert (got.n_tx, got.n_items, got.nnz) == (want.n_tx, want.n_items,
                                                 want.nnz)
    assert got.density == want.density
    assert got.max_item_frequency == want.max_item_frequency
    assert got.item_counts.dtype == want.item_counts.dtype == np.int64
    np.testing.assert_array_equal(got.item_counts, want.item_counts)


def _dense_cases():
    full = _bitmap(1000, 33, 0.5, 3)
    full[:, 5] = 1                      # a column of 1000 ones: > 255
    twos = _bitmap(600, 20, 0.3, 4)
    twos[599, 7] = 2
    return [
        ("uint8 0/1", _bitmap(700, 40, 0.1, 0)),
        ("bool", _bitmap(700, 40, 0.1, 1, np.bool_)),
        ("uint8 past 255 a column", full),
        ("uint8 with a 2 in the last row", twos),
        ("uint8 with 255s", np.full((600, 4), 255, np.uint8)),
        ("int64 counts", np.random.default_rng(5).integers(0, 4, (90, 12))),
        ("int8 0/1", _bitmap(300, 9, 0.2, 6, np.int8)),
        ("uint16 0/1", _bitmap(300, 9, 0.2, 7, np.uint16)),
        ("Fortran order", np.asfortranarray(_bitmap(400, 16, 0.2, 8))),
        ("a row slice", _bitmap(800, 16, 0.2, 9)[::3]),
        ("fewer rows than a block", _bitmap(17, 5, 0.5, 10)),
        ("no rows", np.zeros((0, 6), np.uint8)),
        ("no items", np.zeros((40, 0), np.uint8)),
    ]


@pytest.mark.parametrize("case", _dense_cases(), ids=lambda c: c[0])
def test_dense_stats_equal_reference(case):
    _, T = case
    _same(density_stats(T), ref_density_stats(T))


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
@pytest.mark.parametrize("n_tx", [256, 257, 258, 1021, 2 * 257 * 3 + 7])
def test_threaded_row_ranges_count_exactly(monkeypatch, n_tx, threads):
    """Row ranges of whole blocks on any number of threads, with ragged
    tails, then with bytes above 1 in the last range."""
    monkeypatch.setattr(sparse, "THREADED_COUNT_BYTES", 0)
    monkeypatch.setattr(sparse, "_thread_count", lambda: threads)
    T = _bitmap(n_tx, 70, 0.6, n_tx)
    want = T.astype(np.int64).sum(axis=0)
    np.testing.assert_array_equal(dense_item_counts(T), want)
    T[-1, 3] = 9
    T[:, 4] = 255
    np.testing.assert_array_equal(dense_item_counts(T),
                                  T.astype(np.int64).sum(axis=0))


def test_large_bitmap_takes_the_threaded_path_and_stays_exact(monkeypatch):
    monkeypatch.setattr(sparse, "THREADED_COUNT_BYTES", 1 << 12)
    T = _bitmap(3000, 64, 0.3, 11)
    _same(density_stats(T), ref_density_stats(T))


def test_slab_and_id_list_stats_equal_reference():
    rng = np.random.default_rng(12)
    lists = [sorted(set(rng.integers(0, 50, rng.integers(0, 8)).tolist()))
             for _ in range(400)]
    _same(density_stats(SparseSlab.from_baskets(lists, n_items=50)),
          ref_density_stats(RefSlab.from_baskets(lists, n_items=50)))
    _same(density_stats(lists), ref_density_stats(lists))


def test_three_dimensional_input_raises():
    with pytest.raises(ValueError):
        dense_item_counts(np.zeros((2, 3, 4), np.uint8))

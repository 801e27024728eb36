"""The port's `-s LMS_INDUCED` (``kiss_tpu_torch.ops.lms_native``): the
cases of tests/test_lms_native.py on the port, held against kiss_tpu's
``LmsSorter`` -- bit-identical at k = -1 (the unique full suffix array),
at group level for bounded k (tie-group order is unspecified by the
reference contract) -- and against the port's device strategy and the
oracle."""

import numpy as np
import pytest

from kiss_tpu.ops.lms_native import LmsSorter as JLmsSorter
from kiss_tpu_torch import LmsSorter
from kiss_tpu_torch.ops import lms_native
from kiss_tpu_torch.ops.suffix_sort import Kiss1Sorter
from tests import oracle

CORPORA = [
    ("random", oracle.random_dna(40_000, seed=3)),
    ("repeat", oracle.repeat_heavy_dna(30_000, unit=37, seed=4)),
    ("genome", oracle.genome_like_dna(50_000, ancestral=4096, seed=5)),
    ("tiny", oracle.random_dna(1, seed=6)),
    ("bytes", np.random.default_rng(7).integers(
        0, 256, 20_000).astype(np.int8)),
]
IDS = [c[0] for c in CORPORA]


def _group_ids(text: np.ndarray, sa: np.ndarray, k: int) -> np.ndarray:
    n = len(text)
    pad = np.full(n + k, -1, np.int16)
    pad[:n] = np.asarray(text).astype(np.uint8)  # unsigned byte order
    win = np.lib.stride_tricks.sliding_window_view(pad, k)[: n + 1]
    keys = win[sa]
    neq = np.any(keys[1:] != keys[:-1], axis=1)
    return np.concatenate([[0], np.cumsum(neq)])


def _same_groups(text, a, b, k):
    """Same tie-group structure and the same members in every group."""
    ga, gb = _group_ids(text, a, k), _group_ids(text, b, k)
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(
        a[np.lexsort((a.astype(np.int64), ga))],
        b[np.lexsort((b.astype(np.int64), gb))],
    )


@pytest.mark.parametrize("name,text", CORPORA, ids=IDS)
def test_full_sort_bit_identical(name, text):
    sa = LmsSorter.get_suffix_array_dna(text, -1)
    assert sa.dtype == np.uint32
    np.testing.assert_array_equal(sa,
                                  JLmsSorter.get_suffix_array_dna(text, -1))
    # and the port's device strategy (general alphabet: bytes >= 4 too)
    np.testing.assert_array_equal(
        sa, Kiss1Sorter.get_suffix_array(text, -1, device="cpu")
    )


@pytest.mark.parametrize("name,text", CORPORA, ids=IDS)
@pytest.mark.parametrize("k", [1, 2, 16, 256])
def test_bounded_k_group_conformance(name, text, k):
    sa = LmsSorter.get_suffix_array_dna(text, k)
    _same_groups(text, sa, JLmsSorter.get_suffix_array_dna(text, k), k)
    _same_groups(text, sa,
                 oracle.k_ordered_sa(np.asarray(text).astype(np.uint8), k), k)


def test_matches_device_strategy_at_group_level():
    """LMS_INDUCED vs the port's default device strategy (on the CPU):
    same tie groups, same members."""
    text = oracle.genome_like_dna(30_000, ancestral=2048, seed=11)
    a = LmsSorter.get_suffix_array_dna(text, 32)
    b = Kiss1Sorter.get_suffix_array_dna(text, 32, device="cpu")
    _same_groups(text, a, b, 32)


def test_threads_and_k_sorted_property():
    text = oracle.genome_like_dna(300_000, ancestral=8192, seed=12)
    sa = LmsSorter.get_suffix_array_dna(text, 64, num_threads=2)
    oracle.check_k_sorted(text, sa, 64)


def test_general_entry_dtype_and_sentinel():
    text = oracle.random_dna(1000, seed=13)
    sa = LmsSorter.get_suffix_array(text, 8)
    assert sa.dtype == np.uint32 and sa[0] == len(text)
    np.testing.assert_array_equal(sa, JLmsSorter.get_suffix_array(text, 8))


def test_invalid_k_rejected():
    with pytest.raises(ValueError):
        LmsSorter.get_suffix_array_dna(oracle.random_dna(100), 0)


def test_missing_library_raises_no_device_fallback(monkeypatch):
    monkeypatch.setattr(lms_native.native, "lms_induced_sort",
                        lambda seq, k: None)
    with pytest.raises(RuntimeError, match="native library"):
        LmsSorter.get_suffix_array_dna(oracle.random_dna(100), 16)

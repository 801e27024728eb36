"""kiss_tpu_torch.ops.suffix_sort and K1's plain version against
kiss_tpu, numpy and the reference binary's goldens. Every comparison is
exact (integers, tolerance 0)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kiss_tpu.ops import pack as jpack
from kiss_tpu.ops import suffix_sort as jss
from kiss_tpu_torch.ops import suffix_sort as tss
from kiss_tpu_torch.ops.radix_sort import (
    radix_sort_wide,
    radix_sort_words,
    radix_sort_words_plain,
)
from kiss_tpu_torch.utils import timing
from tests import oracle

torch.set_num_threads(1)

GOLDEN = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.npz"))
)
N_TEXT = 2_000  # one length for every text, so JAX compiles each k once


def _bits(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("w,n,high", [(1, 1, 2**32), (5, 3000, 2**32),
                                      (9, 2500, 2**32), (8, 4000, 3)])
def test_radix_plain_equals_lexsort(w, n, high):
    """Stable: ties keep input order, so the permutation is exactly
    lexsort's with the row index as the last tiebreak."""
    rng = np.random.default_rng(w * n)
    keys = rng.integers(0, high, (w, n), dtype=np.uint64).astype(np.uint32)
    order = np.lexsort([np.arange(n)] + [keys[i] for i in range(w - 1, -1,
                                                                 -1)])
    sk, perm = radix_sort_words_plain(_bits(keys))
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(sk.numpy().view(np.uint32), keys[:, order])
    # on a CPU tensor the wrapper is the plain version
    sk2, perm2 = radix_sort_words(_bits(keys))
    assert torch.equal(perm2, perm) and torch.equal(sk2, sk)


def test_radix_stable_payload():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 2, (8, 5000)).astype(np.uint32)
    payload = rng.permutation(5000)
    _, perm = radix_sort_words(_bits(keys))
    order = np.lexsort([np.arange(5000)] + [keys[i] for i in range(7, -1,
                                                                   -1)])
    np.testing.assert_array_equal(payload[perm.numpy()], payload[order])


@pytest.mark.parametrize("w,high", [(10, 2**32), (19, 3)])
def test_radix_wide_equals_lexsort(w, high):
    """More than 9 words: stable K1 sorts of word groups, least
    significant group first, give lexsort's permutation."""
    rng = np.random.default_rng(w)
    n = 3000
    keys = rng.integers(0, high, (w, n), dtype=np.uint64).astype(np.uint32)
    order = np.lexsort([np.arange(n)] + [keys[i] for i in range(w - 1, -1,
                                                                 -1)])
    sk, perm = radix_sort_wide(_bits(keys))
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(sk.numpy().view(np.uint32), keys[:, order])


def test_radix_rejects_bad_input():
    with pytest.raises(TypeError):
        radix_sort_words(torch.zeros((2, 5), dtype=torch.int64))
    with pytest.raises(ValueError):
        radix_sort_words(torch.zeros((10, 5), dtype=torch.int32))


def _texts():
    return {
        "random": oracle.random_dna(N_TEXT, seed=21),
        "tandem": oracle.repeat_heavy_dna(N_TEXT, unit=37, seed=22),
    }


@pytest.mark.parametrize("strategy", ["wide", "doubling"])
@pytest.mark.parametrize("k", [1, 16, 63, 64, 65, 100, 256, -1])
def test_sa_bit_identical_to_kiss_tpu(k, strategy):
    for name, text in _texts().items():
        want = jss.k_ordered_suffix_array(text, k, strategy=strategy)
        got = tss.k_ordered_suffix_array(text, k, strategy=strategy,
                                         device="cpu")
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=f"{name} k={k}")


def test_wide_round_bit_identical_to_kiss_tpu():
    """k = 4095 over repeats longer than k: the last round sorts 14 rank
    keys and 63 raw tail characters, 16 packed words, above K1's 9."""
    text = oracle.repeat_heavy_dna(20_000, unit=3000, seed=1)
    np.testing.assert_array_equal(
        tss.k_ordered_suffix_array(text, 4095, device="cpu"),
        jss.k_ordered_suffix_array(text, 4095),
    )


def _general_texts():
    rng = np.random.default_rng(23)
    tandem = np.tile(rng.integers(0, 256, 300), 7)[:N_TEXT]
    tandem[rng.integers(0, N_TEXT, 10)] = 0
    return {
        "20 symbols": rng.integers(0, 20, N_TEXT).astype(np.int8),
        "bytes, tandem": tandem.astype(np.uint8).view(np.int8),
    }


@pytest.mark.parametrize("sorter", ["Kiss1Sorter", "Kiss2Sorter"])
@pytest.mark.parametrize("k", [16, 100, 256, -1])
def test_general_alphabet_bit_identical_to_kiss_tpu(k, sorter):
    """get_suffix_array (10-bit characters, a 12-character seed for the
    wide strategy, 3 for doubling) equals kiss_tpu's."""
    for name, text in _general_texts().items():
        got = getattr(tss, sorter).get_suffix_array(text, k, device="cpu")
        want = getattr(jss, sorter).get_suffix_array(text, k)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=f"{name} k={k}")


@pytest.mark.parametrize("k", [100, -1])
def test_device_form_equals_host_form(k):
    text = _texts()["tandem"]
    host = tss.k_ordered_suffix_array(text, k, device="cpu")
    dev = tss.k_ordered_suffix_array_device(torch.from_numpy(text), k)
    np.testing.assert_array_equal(dev.numpy(), host.astype(np.int64))


@pytest.mark.parametrize("seed_chars", [64, 16])
def test_seed_sort_matches_kiss_tpu(seed_chars):
    """The seed sort on its words from ``pack.seed_key_words``: SA, rank
    and the flags of the tied rows (none set: ``kiss_tpu``'s all-singleton
    flag) equal ``kiss_tpu``'s on the same text."""
    text = oracle.repeat_heavy_dna(N_TEXT, unit=37, seed=5)
    sa_j, rank_j, done_j = jss._seed_sort(jnp.asarray(text), seed_chars,
                                          jpack.DNA, True)
    sa_t, rank_t, tied_t = tss._seed_sort(torch.from_numpy(text), seed_chars,
                                          tss.pack.DNA, True)
    np.testing.assert_array_equal(sa_t.numpy(), np.asarray(sa_j))
    np.testing.assert_array_equal(rank_t.numpy(), np.asarray(rank_j))
    active_j, _ = jss._active_rows_of(sa_j, rank_j)
    np.testing.assert_array_equal(tied_t.numpy(), np.asarray(active_j))
    assert (not tied_t.any()) == bool(done_j)


def test_tail_refine_step_matches_kiss_tpu():
    """One compacted refinement step on identical state, from the seed's
    tied rows, with a capacity above the active count (fill rows alias
    row 0 and write the sentinel through duplicate indices)."""
    text = oracle.repeat_heavy_dna(N_TEXT, unit=37, seed=22)
    n = len(text)
    sa_j, rank_j, _ = jss._seed_sort(jnp.asarray(text), 64, jpack.DNA, True)
    active_j, m_j = jss._active_rows_of(sa_j, rank_j)
    m = int(m_j)
    cap = jss._next_capacity(m, n + 1)
    assert cap > m > 0
    rows_j = jss._compact_rows(active_j, cap)

    sa_t, rank_t, tied_t = tss._seed_sort(torch.from_numpy(text), 64,
                                          tss.pack.DNA, True)
    ids = tss._compact_rows(tied_t)
    assert ids.shape[0] == m
    rows_t = torch.zeros(cap, dtype=torch.int64)
    rows_t[:m] = ids
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))

    out_j = jss._tail_refine(sa_j, rank_j, rows_j, jnp.int32(64))
    out_t = tss._tail_refine(sa_t, rank_t, rows_t, m, 64)
    for name, a, b in zip(("sa", "rank", "rows"), out_j[:3], out_t[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert out_t[3] == int(out_j[3])


def _tied_rule_texts():
    """N_TEXT characters each, on both sides of the tied-share rule at the
    64-character seed: a few planted repeats in random DNA (compacted),
    all-A and AC-periodic (every row tied: the whole array), and two
    repeat-heavy texts just below and just above the crossover (74.4% and
    76.2% of the rows tied)."""
    planted = oracle.random_dna(N_TEXT, seed=31)
    planted[900:1100] = planted[100:300]
    planted[1500:1700] = planted[100:300]
    return {
        "planted": planted,
        "all-A": np.zeros(N_TEXT, np.int8),
        "AC": np.tile(np.array([0, 1], np.int8), N_TEXT // 2),
        "repeat-heavy below": oracle.repeat_heavy_dna(N_TEXT, unit=37,
                                                      seed=6),
        "repeat-heavy above": oracle.repeat_heavy_dna(N_TEXT, unit=37,
                                                      seed=1),
    }


def _tied_rows_np(text: np.ndarray, c: int) -> int:
    """Suffixes that share their first c characters (a shorter suffix
    only with an equal one) with another, by numpy's unique over the
    windows: the rows still tied after a c-character seed."""
    n = len(text)
    pad = np.full(n + c, -1, np.int16)
    pad[:n] = text
    win = np.lib.stride_tricks.sliding_window_view(pad, c)[: n + 1]
    _, inv, cnt = np.unique(win, axis=0, return_inverse=True,
                            return_counts=True)
    return int((cnt[inv.ravel()] > 1).sum())


def _traced(text, k, strategy="wide"):
    """(SA, the span records) of one host-path sort under a CPU
    profiler."""
    timing.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            sa = tss.k_ordered_suffix_array(text, k, strategy=strategy,
                                            device="cpu")
        return sa, list(timing.RECORDS)
    finally:
        timing.reset_spans()


@pytest.mark.parametrize("strategy", ["wide", "doubling"])
@pytest.mark.parametrize("k", [100, 128, 256, -1])
def test_tied_rounds_bit_identical_to_kiss_tpu(k, strategy):
    """On texts that take each branch of the tied-share rule, the SA
    equals ``kiss_tpu``'s and the single-program form's (every round over
    the whole array)."""
    for name, text in _tied_rule_texts().items():
        want = jss.k_ordered_suffix_array(text, k, strategy=strategy)
        got = tss.k_ordered_suffix_array(text, k, strategy=strategy,
                                         device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=f"{name} k={k}")
        full = tss.k_ordered_suffix_array_device(torch.from_numpy(text), k,
                                                 strategy=strategy)
        np.testing.assert_array_equal(full.numpy(), want.astype(np.int64),
                                      err_msg=f"{name} k={k} device form")


@pytest.mark.parametrize("k", [256, -1])
@pytest.mark.parametrize("name", sorted(_tied_rule_texts()))
def test_tied_share_rule_picks_the_path(name, k):
    """After the 64-character seed, a round runs on the tied rows alone
    where they are at most ``_TIED_SHARE_MAX`` of the rows, else over the
    whole array; the counters say so: ``sort_rows`` N once a sort, and
    ``sort_rows_tied`` each compacted round's rows, the first the seed's
    tied rows by numpy's count."""
    text = _tied_rule_texts()[name]
    N = len(text) + 1
    tied = _tied_rows_np(text, 64)
    sa, recs = _traced(text, k)
    np.testing.assert_array_equal(sa, oracle.k_ordered_sa(
        text, k if k > 0 else None))
    names = [r.name for r in recs]
    sort = recs[names.index("kiss.sort")].counts
    assert sort.get("sort_rows") == (N if tied else None)
    compact = [r.counts.get("sort_rows_tied") for r in recs
               if r.name in ("kiss.sort.round", "kiss.sort.tail")]
    if 0 < tied <= tss._TIED_SHARE_MAX * N:
        assert compact[0] == tied
        assert all(compact)
        # at k = -1 the tail refinement takes over from the seed
        assert ("kiss.sort.round" in names) == (k > 0)
    elif tied:
        # the first round over the whole array; at k = -1 the tail
        # refinement may take over after it
        assert compact[0] is None and names[2] == "kiss.sort.round"
        if k > 0:
            assert compact == [None]
    # the texts' sides of the rule
    compacted = name in ("planted", "repeat-heavy below")
    assert (0 < tied <= tss._TIED_SHARE_MAX * N) == compacted


def test_sorter_facades_and_limits():
    text = _texts()["tandem"]
    a = tss.Kiss1Sorter.get_suffix_array_dna(text, 80, device="cpu")
    b = tss.Kiss2Sorter.get_suffix_array_dna(text, 80, num_threads=8,
                                             device="cpu")
    np.testing.assert_array_equal(a, b)  # -t 8 clamps to the one CPU
    np.testing.assert_array_equal(a, oracle.k_ordered_sa(text, 80))
    # the general-alphabet entry orders DNA text the same way
    np.testing.assert_array_equal(
        tss.Kiss1Sorter.get_suffix_array(text, 80, device="cpu"), a
    )


@pytest.mark.parametrize("n", [0, 1, 2, 17])
def test_tiny_texts(n):
    text = oracle.random_dna(n, seed=n)
    for k in (1, 5, -1):
        np.testing.assert_array_equal(
            tss.k_ordered_suffix_array(text, k, device="cpu"),
            oracle.k_ordered_sa(text, k if k > 0 else None),
        )


def test_cuda_default_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without")
    with pytest.raises(RuntimeError, match="cuda"):
        tss.k_ordered_suffix_array(oracle.random_dna(50), 8)


def _group_ids(text: np.ndarray, sa: np.ndarray, k: int) -> np.ndarray:
    """Each SA row's equal-k-prefix group id (tests/test_golden.py)."""
    n = len(text)
    pad = np.full(n + k, -1, np.int16)
    pad[:n] = text
    win = np.lib.stride_tricks.sliding_window_view(pad, k)[: n + 1]
    keys = win[sa]
    neq = np.any(keys[1:] != keys[:-1], axis=1)
    return np.concatenate([[0], np.cumsum(neq)])


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_golden_unbounded_bit_identical(path):
    data = np.load(path)
    ours = tss.k_ordered_suffix_array(data["text"], -1, device="cpu")
    np.testing.assert_array_equal(ours, data["sa_kiss1_k-1"])
    np.testing.assert_array_equal(ours, data["sa_kiss2_k-1"])


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
@pytest.mark.parametrize("k", [16, 32, 256])
def test_golden_bounded_tie_group_conformance(path, k):
    data = np.load(path)
    text = data["text"]
    ours = tss.k_ordered_suffix_array(text, k, device="cpu")
    for algo in ("kiss1", "kiss2"):
        ref = data[f"sa_{algo}_k{k}"]
        gids = _group_ids(text, ref, k)
        gids_ours = _group_ids(text, ours, k)
        np.testing.assert_array_equal(gids, gids_ours)
        order_ref = np.lexsort((ref, gids))
        order_ours = np.lexsort((ours, gids_ours))
        np.testing.assert_array_equal(ref[order_ref], ours[order_ours])

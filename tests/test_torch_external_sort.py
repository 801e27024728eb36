"""The port's out-of-core sorter (``kiss_tpu_torch.ops.external_sort``)
on the CPU, where each batch runs K1's plain version: the cases of
tests/test_external_sort.py, each bit-identical to
``kiss_tpu.ops.external_sort`` and to the port's in-core SA, with batch
capacities small enough that many bucket-aligned batches and several
refinement segments run; a round whose columns exceed K1's 9 words; the
copied host stages against the port's device packing."""

import numpy as np
import pytest
import torch

from kiss_tpu.ops import external_sort as jext
from kiss_tpu_torch.ops import external_sort as ext
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops import suffix_sort as tss
from kiss_tpu_torch.utils.checks import check_k_sorted_sample
from tests import oracle

torch.set_num_threads(1)


def _random():
    return oracle.random_dna(20_000, seed=1)


def _repeat_heavy():
    # tandem repeats force ties past the 64-char seed so wide rounds and
    # (for -1) multiple coverage rounds run
    unit = oracle.random_dna(13, seed=3)
    text = np.tile(unit, 2500)[:30_000].copy()
    text[15_000:] = oracle.random_dna(15_000, seed=4)
    return text


def _dispersed():
    text = oracle.random_dna(24_000, seed=7)
    seg = text[2_000:4_000].copy()
    for at in (9_000, 14_500, 20_000):
        text[at : at + seg.size] = seg
    return text


def _tail_tandem():
    unit = oracle.random_dna(11, seed=31)
    text = np.tile(unit, 3000)[:30_000].copy()
    text[18_000:] = oracle.random_dna(12_000, seed=32)
    return text


def _multi_level():
    unit = oracle.random_dna(7, seed=33)
    text = np.tile(unit, 5000)[:32_000].copy()
    text[24_000:] = oracle.random_dna(8_000, seed=34)
    return text


def _saved_level():
    unit = oracle.random_dna(17, seed=9)
    text = np.tile(unit, 2000)[:30_000].copy()
    text[20_000:] = oracle.random_dna(10_000, seed=10)
    return text


CASES = [
    *[("random", _random, k, {"batch_rows": 4096})
      for k in (4, 16, 64, 256, -1)],
    *[("repeat", _repeat_heavy, k, {"batch_rows": 4096})
      for k in (64, 256, -1)],
    # 2-char buckets (16 in all): batches spanning many buckets
    ("dispersed", _dispersed, 256, {"batch_rows": 2048, "bucket_chars": 2}),
    # one giant tie group (one bucket); the end-of-text rule dominates
    *[("all_same", lambda: np.zeros(5_000, np.int8), k, {"batch_rows": 8192})
      for k in (64, -1)],
    ("tiny", lambda: np.array([2, 1, 3, 0, 0, 1], np.int8), 4,
     {"batch_rows": 4096, "bucket_chars": 1}),
    ("tiny", lambda: np.array([2, 1, 3, 0, 0, 1], np.int8), -1,
     {"batch_rows": 4096, "bucket_chars": 1}),
    # raw-tail rounds: k not a multiple of the 64-char seed
    *[("tail", _tail_tandem, k, {"batch_rows": 4096})
      for k in (100, 150, 200)],
    # k = 680 = 512 + 2*64 + 40: two saved rank levels AND raw tail words
    ("multi_level", _multi_level, 680, {"batch_rows": 4096}),
    # k = 576 = 512 + 64: the final round references both levels (the
    # copy-on-save guard)
    ("saved_level", _saved_level, 576, {"batch_rows": 4096}),
]


@pytest.mark.parametrize(
    "name,make,k,kw", CASES,
    ids=[f"{c[0]}-k{c[2]}" for c in CASES],
)
def test_bit_identical_to_kiss_tpu_and_in_core(name, make, k, kw):
    text = make()
    got = ext.external_k_ordered_suffix_array(text, k, device="cpu", **kw)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(
        got, jext.external_k_ordered_suffix_array(text, k, **kw)
    )
    np.testing.assert_array_equal(
        got, tss.k_ordered_suffix_array(text, k, device="cpu")
    )


def test_round_wider_than_k1(monkeypatch):
    """k = 4095 = 7 * 512 + 7 * 64 + 63 over repeats longer than k: the
    last round sorts 14 rank keys, 8 raw tail words and the position (23
    columns); packed, they still need 16 words, so the segment runs as
    two stable K1 sorts. Bit-identical to kiss_tpu and the in-core port
    (which takes the same wide sort)."""
    text = oracle.repeat_heavy_dna(20_000, unit=3000, seed=1)
    widths = []

    def recording(keys):
        widths.append(keys.shape[0])
        return tss.radix_sort_wide(keys)

    monkeypatch.setattr(ext, "radix_sort_wide", recording)
    got = ext.external_k_ordered_suffix_array(text, 4095, batch_rows=4096,
                                              device="cpu")
    assert max(widths) == 16
    np.testing.assert_array_equal(
        got, jext.external_k_ordered_suffix_array(text, 4095,
                                                  batch_rows=4096)
    )
    np.testing.assert_array_equal(
        got, tss.k_ordered_suffix_array(text, 4095, device="cpu")
    )


def test_empty_and_device_rule():
    assert ext.external_k_ordered_suffix_array(
        np.empty(0, dtype=np.int8), 16, device="cpu"
    ).tolist() == [0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ext.external_k_ordered_suffix_array(oracle.random_dna(10), 16)


def test_oversized_tie_group_raises_like_kiss_tpu():
    text = np.zeros(10_000, dtype=np.int8)  # one bucket, one tie group
    with pytest.raises(ValueError, match="tie group|bucket") as got:
        ext.external_k_ordered_suffix_array(text, 256, batch_rows=1024,
                                            device="cpu")
    with pytest.raises(ValueError) as want:
        jext.external_k_ordered_suffix_array(text, 256, batch_rows=1024)
    assert str(got.value) == str(want.value)


def test_tail_words_match_port_pack():
    text = oracle.random_dna(500, seed=35)
    pA = np.array([0, 3, 450, 470, 492, 499, 500], dtype=np.uint32)
    for tail_chars, tail_offset in [(1, 64), (8, 64), (36, 64), (40, 640)]:
        want = pack.suffix_key_words(torch.from_numpy(text), tail_chars,
                                     tail_offset, pack.DNA)
        got = ext._np_tail_words(text, pA, tail_chars, tail_offset)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy()[pA.astype(np.int64)])


def test_seed_words_match_port_pack():
    text = oracle.random_dna(1000, seed=5)
    w0p = ext._np_word0_padded(text, 48)
    want = pack.suffix_key_words_2bit(torch.from_numpy(text), 64, 0)
    for w in range(4):
        generic = ext._np_seed_word(text, w, 16)
        np.testing.assert_array_equal(w0p[16 * w : 16 * w + generic.size],
                                      generic)
        np.testing.assert_array_equal(generic, want[w].numpy())


def test_sortedness_property_large():
    """The reference's own oracle (tests/kiss.cpp:26-28) at a size that
    spans many batches."""
    text = oracle.random_dna(120_000, seed=21)
    sa = ext.external_k_ordered_suffix_array(text, 32, batch_rows=16_384,
                                             device="cpu")
    oracle.check_k_sorted(text, sa, 32)
    np.testing.assert_array_equal(
        sa, tss.k_ordered_suffix_array(text, 32, device="cpu")
    )


@pytest.mark.parametrize("verbose", [False, True])
def test_split_is_filled_when_asked(caplog, verbose):
    """A caller-given ``split`` gets every stage's seconds and the counts
    of batches and segments; ``verbose`` logs it; without either nothing
    is timed or logged."""
    text = _repeat_heavy()
    want = tss.k_ordered_suffix_array(text, 100, device="cpu")
    split = {}
    with caplog.at_level("DEBUG", logger="kiss_tpu_torch"):
        sa = ext.external_k_ordered_suffix_array(
            text, 100, batch_rows=4_096, device="cpu", split=split,
            verbose=verbose)
        plain = ext.external_k_ordered_suffix_array(
            text, 100, batch_rows=4_096, device="cpu")
    np.testing.assert_array_equal(sa, want)
    np.testing.assert_array_equal(plain, want)
    assert split["seed batches"] >= 6 and split["round segments"] >= 1
    assert {"bucketize", "columns", "seed upload", "seed sort",
            "seed download", "round upload", "round sort", "round download",
            "rounds", "total"} <= set(split)
    assert all(v >= 0 for v in split.values())
    logged = [r.getMessage() for r in caplog.records
              if "external_sort: split" in r.getMessage()]
    assert len(logged) == int(verbose)


@pytest.mark.parametrize("broken", [None, "swap", "duplicate"])
def test_check_k_sorted_sample(broken):
    """The device-side sample check that chip_smoke.py and
    experiments/external_scale.py hold the SA to: it passes the in-core
    SA and raises on two swapped adjacent rows or a repeated row."""
    text = oracle.random_dna(3_000, seed=41)
    sa = tss.k_ordered_suffix_array(text, 16, device="cpu").astype(np.int64)
    if broken == "swap":
        sa[1:] = sa[1:].reshape(-1, 2)[:, ::-1].reshape(-1)
    elif broken == "duplicate":
        sa[5] = sa[6]
    run = lambda: check_k_sorted_sample(  # noqa: E731
        torch.from_numpy(text), torch.from_numpy(sa), 16, 2_000)
    if broken is None:
        run()
    else:
        with pytest.raises(RuntimeError, match="out of order|permutation"):
            run()

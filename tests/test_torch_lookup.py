"""The seed table (``lookup_len`` L > 0) on the CPU: the port's table and
its seeded backward search (``get_range_packed_device`` from
``lookup[key]``, ``lookup[key + 1]``) held against the plain reference
(``kissbench.reference_lookup``) entry for entry and range for range, on
``synth_genome`` texts at 63, 4,031 and 70,000 characters with L in {1,
4, 7} (n < 4^L too, where most seeds are absent); the occurrence totals
and checksums against lookup 0's; and the span ``kiss.build.lookup`` and
the counters ``k2_queries``, ``k2_lookup_reads`` under a profiler."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.utils import timing
from kissbench import reference
from kissbench import reference_lookup as rl
from kissbench.synth import pack_queries_2bit, sample_patterns, synth_genome

DEPTHS = (1, 4, 7)
QLEN_MAX = 25


@pytest.fixture(scope="module", params=[(63, 1), (4031, 5), (70_000, 2)],
                ids=lambda p: f"n{p[0]}")
def indexed(request):
    """A text, its oracle and the port's index of it at each depth."""
    n, seed = request.param
    text = synth_genome(n, seed)
    oracle = reference.KmerOracle(torch.from_numpy(text), QLEN_MAX, 4)
    return text, oracle, {
        L: fm.FMIndex(sa_intv=4, lookup_len=L, device="cpu").build(text)
        for L in DEPTHS}


def _patterns(text, table, L: int, qlen: int, seed: int) -> np.ndarray:
    """400 patterns sampled as the benchmark samples them (16 of one or two
    characters, each with thousands of occurrences to walk), and where
    qlen >= L one whose seed is absent from the text (if any is) and one
    whose seed is the last, all 3s (its key + 1 is 4^L)."""
    pats = sample_patterns(text, 400 if qlen > 2 else 16, qlen, seed=seed)
    if qlen < L:
        return pats
    rng = np.random.default_rng(seed)
    extra = []
    absent = torch.nonzero(table[1:] == table[:-1]).reshape(-1)
    seeds = [int(absent[len(absent) // 2])] if len(absent) else []
    for s in seeds + [4**L - 1]:
        p = rng.integers(0, 4, qlen).astype(np.int8)
        p[qlen - L:] = [(s >> (2 * (L - 1 - j))) & 3 for j in range(L)]
        extra.append(p)
    return np.concatenate([pats, np.stack(extra)])


def _search(index, pats: np.ndarray, lookup_len: int):
    qw = torch.from_numpy(pack_queries_2bit(pats).view(np.int32))
    return fm.get_range_packed_device(index.arrays, qw, pats.shape[1],
                                      lookup_len, blocks=index.blocks)


def _short_rows(oracle, beg, end, qlen: int):
    """(rows, sum of positions) in the ranges whose suffixes are shorter
    than ``qlen``."""
    n = oracle.keys.shape[0] - 1
    short = oracle.pos > n - qlen
    rows = torch.zeros(n + 2, dtype=torch.int64)
    pos = torch.zeros(n + 2, dtype=torch.int64)
    torch.cumsum(short, dim=0, out=rows[1:])
    torch.cumsum(oracle.pos * short, dim=0, out=pos[1:])
    return (int((rows[end] - rows[beg]).sum()),
            int((pos[end] - pos[beg]).sum()))


@pytest.mark.parametrize("L", DEPTHS)
def test_the_seed_table_is_the_reference(indexed, L):
    text, oracle, indexes = indexed
    got = indexes[L].arrays.lookup
    want = rl.seed_table(oracle, L)
    assert got.shape == (4**L + 1,) and int(want[-1]) == len(text) + 1
    assert reference.tables_differ({"lookup": got}, {"lookup": want}) == 0
    if len(text) < 4**L:  # most seeds absent: equal neighbours
        assert int((want[1:] == want[:-1]).sum()) > 4**L // 2


SHAPES = [(L, qlen) for L in DEPTHS for qlen in (L - 1, L, L + 1, QLEN_MAX)
          if qlen >= 1]


@pytest.mark.parametrize("L,qlen", SHAPES,
                         ids=[f"L{L}-q{q}" for L, q in SHAPES])
def test_seeded_ranges_and_stats_are_the_reference(indexed, L, qlen):
    text, oracle, indexes = indexed
    index = indexes[L]
    table = rl.seed_table(oracle, L)
    pats = _patterns(text, table, L, qlen, seed=len(text) + 7 * qlen + L)
    p = torch.from_numpy(pats)
    got = _search(index, pats, L)
    want = rl.seeded_search(oracle, table, L, p)
    assert reference.ranges_differ(got, want[:3]) == 0
    # the occurrences and checksum: the walk's over the seeded ranges are
    # the reference's, and lookup 0's plus the rows of any suffix shorter
    # than the pattern that a seeded range holds (reference_lookup's
    # docstring: a seed's range runs up to the next seed's rows)
    stats = fm.batch_locate_stats_device(index.arrays, got[0], got[1], 4,
                                         blocks=index.blocks)
    assert stats == oracle.stats(want[0], want[1])[:2]
    plain = _search(index, pats, 0)
    unseeded = fm.batch_locate_stats_device(index.arrays, plain[0],
                                            plain[1], 4, blocks=index.blocks)
    assert reference.ranges_differ(plain, oracle.search(p)[:3]) == 0
    extra = _short_rows(oracle, want[0], want[1], qlen)
    assert stats == (unseeded[0] + extra[0], unseeded[1] + extra[1])
    if qlen < L:
        assert int(want[3].sum()) == int(oracle.search(p)[3].sum())
    else:  # at most qlen - L steps a pattern, each where the range lives
        assert int(want[3].max()) <= qlen - L


@pytest.fixture
def clean():
    timing.reset_spans()
    yield
    timing.reset_spans()


def test_the_lookup_span_and_k2_counters_under_a_profiler(clean):
    text = synth_genome(4031, 5)
    pats = sample_patterns(text, 300, 9, seed=3)
    with profile(activities=[ProfilerActivity.CPU]):
        index = fm.FMIndex(sa_intv=4, lookup_len=4, device="cpu").build(text)
    summary = timing.span_summary()
    recs = timing.RECORDS
    assert summary["kiss.build.lookup"]["count"] == 1
    lookup = next(r for r in recs if r.name == "kiss.build.lookup")
    assert recs[lookup.parent].name == "kiss.build"
    # the table's K2 launch: every seed, unseeded
    assert summary["kiss.build.lookup"]["counts"] == {
        "k2_queries": 4**4, "k2_lookup_reads": 0}
    short = sample_patterns(text, 300, 3, seed=4)  # below L: unseeded
    for batch, L, reads in [(pats, 4, 300), (pats, 0, 0), (short, 4, 0)]:
        timing.reset_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            _search(index, batch, L)
        assert timing.span_summary()["kiss.query.search"]["counts"] == {
            "k2_queries": 300, "k2_lookup_reads": reads}


def test_no_profiler_records_nothing(clean):
    text = synth_genome(4031, 5)
    index = fm.FMIndex(sa_intv=4, lookup_len=4, device="cpu").build(text)
    _search(index, sample_patterns(text, 300, 9, seed=3), 4)
    assert timing.RECORDS == [] and timing.span_summary() == {}

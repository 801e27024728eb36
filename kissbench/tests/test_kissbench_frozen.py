"""The benchmark's frozen copies and its plain reference, held against
the program's sources and outputs on small inputs: the generators and
packing element for element, the bound arithmetic on indexes the program
built, the oracle's counts of the query kernels' work against the
program's experiment counters, and the reference's suffix arrays, tables
and ranges against the program's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kiss_tpu_torch.experiments import fm_query_time as fqt
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack, suffix_sort
from kiss_tpu_torch.utils import roofline, synth as port_synth
from kissbench import bounds, reference, synth


@pytest.mark.parametrize("n,seed", [(1, 0), (5000, 3), (2_200_000, 2**33 + 5)])
def test_synth_genome_is_the_programs(n, seed):
    assert np.array_equal(synth.synth_genome(n, seed),
                          port_synth.synth_genome(n, seed))


@pytest.mark.parametrize("nq,qlen,seed", [(1, 25, 7), (3000, 25, 11),
                                          (500, 33, 2**40)])
def test_sample_patterns_and_packing_are_the_programs(nq, qlen, seed):
    text = synth.synth_genome(50_000, 1)
    pats = synth.sample_patterns(text, nq, qlen, seed)
    assert np.array_equal(pats,
                          port_synth.sample_patterns(text, nq, qlen, seed))
    assert np.array_equal(synth.pack_queries_2bit(pats),
                          pack.np_pack_queries_2bit(pats))


def test_bound_arithmetic_is_the_programs():
    assert bounds.PEAK_BYTES_PER_S == roofline.PEAK_BYTES_PER_S
    assert bounds.PEAK_INT32_OPS_PER_S == roofline.PEAK_INT32_OPS_PER_S
    for b, o in [(1e9, 1e9), (1e6, 1e12), (0, 0)]:
        assert bounds.bound_ms(b, o) == roofline.bound_ms(b, o)


@pytest.fixture(scope="module", params=[(63, 1), (4031, 5), (4095, 3),
                                        (70_000, 2)])
def indexed(request):
    """A text, the program's full-order and 32-ordered indexes of it, a
    batch of patterns and the oracle."""
    n, seed = request.param
    text = synth.synth_genome(n, seed)
    full = fm.FMIndex(sa_intv=4, device="cpu").build(text)
    k32 = fm.FMIndex(sa_intv=4, device="cpu").build(text, sort_len=32)
    qlen = 25 if n > 100 else 9
    pats = synth.sample_patterns(text, 2000, qlen, seed=seed + 1)
    tt = torch.from_numpy(text)
    return text, full, k32, pats, reference.KmerOracle(tt, qlen, 4)


def test_index_sizes_are_the_live_tables(indexed):
    text, full, _, _, _ = indexed
    sizes = bounds.IndexSizes.of(len(text), 4)
    a, b = full.arrays, full.blocks
    assert sizes == (a.lf_tab.numel() * 4, a.b_tab.numel() * 4,
                     b.blk.numel() * 4, b.sup.numel() * 8,
                     a.sa_samp.numel() * 8, a.lookup.numel())


def test_bounds_and_counts_are_the_programs(indexed):
    text, full, k32, pats, oracle = indexed
    sizes = bounds.IndexSizes.of(len(text), 4)
    qlen = pats.shape[1]
    qw = torch.from_numpy(synth.pack_queries_2bit(pats).view(np.int32))
    beg, end, offs = fm.get_range_packed_device(full.arrays, qw, qlen, 0,
                                                blocks=full.blocks)
    rb, re_, ro, steps = oracle.search(torch.from_numpy(pats))
    assert torch.equal(beg, rb) and torch.equal(end, re_)
    assert torch.equal(offs, ro)
    lf_steps = fqt.k2_sectors(full.arrays, qw, qlen)[0]
    assert int(steps.sum()) == lf_steps
    fqt.QLEN = qlen
    assert bounds.k2_bound(sizes, len(pats), qw.numel(), lf_steps) == \
        fqt.k2_bound(full, len(pats), qw.numel(), lf_steps)
    rows, checksum, walk = oracle.stats(rb, re_)
    assert (rows, checksum) == fm.batch_locate_stats_device(
        full.arrays, beg, end, 4, blocks=full.blocks)
    range_rows = fqt.range_rows(beg, end)
    assert walk == fqt.walk_sectors(full.arrays, range_rows, 4)[0]
    assert bounds.k3_bound(sizes, 16 * len(pats) + 8, walk, rows) == \
        fqt.k3_bound(full, 16 * len(pats) + 8, walk, rows)
    b2, e2, _ = fm.get_range_packed_device(k32.arrays, qw, qlen, 0,
                                           blocks=k32.blocks)
    assert torch.equal(b2, rb) and torch.equal(e2, re_)
    work = oracle.bfs_work(rb, re_)
    assert work == fqt.bfs_work(k32.arrays, b2, e2, 4)
    assert bounds.k4_bound(sizes, len(pats), work, True) == \
        fqt.k4_bound(k32, len(pats), work, True)
    assert (rows, checksum) == fm.bfs_query_stats(k32.arrays, b2, e2, 4,
                                                  blocks=k32.blocks)


def test_reference_suffix_arrays_are_the_programs(indexed):
    text = indexed[0]
    tt = torch.from_numpy(text)
    for k in (1, 3, 16, 100, 256, None):
        want = suffix_sort.k_ordered_suffix_array(
            text, -1 if k is None else k, as_numpy=False, device="cpu")
        assert torch.equal(reference.suffix_array(tt, k), want), k


def test_reference_tables_and_search_are_the_programs(indexed):
    text, full, _, pats, oracle = indexed
    tt = torch.from_numpy(text)
    want = reference.fm_tables(tt, reference.suffix_array(tt, None), 4)
    got = {name: (reference.unsigned_words(getattr(full.arrays, name))
                  if name in ("bwt_words", "b_words")
                  else getattr(full.arrays, name))
           for name in reference.TABLES}
    assert reference.tables_differ(got, want) == 0
    p = torch.from_numpy(pats)
    assert reference.ranges_differ(reference.backward_search(want, p),
                                   oracle.search(p)[:3]) == 0

"""The occurrence tables' one helper (``fm_index.occ_tables``) on the CPU,
where it runs its plain version:

- ``occ_tables_plain`` against frozen copies of the expressions the two
  builders wrote before the helper (the whole-array build's
  ``_word_symbol_counts`` and occ scans, and the row-blocked build's
  ``fm_index.block_counts`` / ``block_tables``), table for table, at row counts on
  both sides of multiples of 16, 256 and 65,536, the sentinel in the first
  word, a middle superblock and the last word, and with block offsets;
- ``_fuse_lf_tab`` (what ``FMIndex.load`` fuses) of the helper's occ1 and
  occ2 is its lf_tab;
- the three builders (``build_index_device``, ``build_index_rows`` at
  several block sizes, the mesh build) write the same ``.fmi`` bytes as
  ``kiss_tpu``, at sa_intv 4 and 1.

Every comparison is exact (integers, tolerance 0). The kernel itself (K6,
``csrc/occ_tables.cu``) is held to the plain version on the card in
``tests/test_torch_kernels.py``."""

import io

import numpy as np
import pytest
import torch

from kiss_tpu.models import fm_index as jfm
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.parallel import fm_build, make_mesh
from tests import oracle

torch.set_num_threads(1)


def bwt_words(N: int, pri: int, seed: int) -> torch.Tensor:
    """Random packed BWT words of N rows (ceil(N / 16) words, the lanes
    past N random too) whose row ``pri`` holds symbol 0, as the BWT puts
    the sentinel."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(-2**31, 2**31, (-(-N // 16),), dtype=torch.int64,
                      generator=g)
    if 0 <= pri < N:
        w[pri // 16] &= ~(3 << (2 * (pri % 16)))
    return pack.to_u32_bits(w)


# ---- the expressions the builders wrote before the helper, frozen


def _frozen_whole(words, N, pri):
    """build_index_device's occ tables, cnt and _fuse_lf_tab's lf_tab."""
    W = words.shape[0]
    starts = torch.arange(W, dtype=torch.int64)
    t = torch.clamp(N - starts * 16, max=16)
    c16 = torch.stack([pack.count_symbol_prefix(words, c, t)
                       for c in range(4)], dim=1)
    c16[:, 0].index_add_(0, (pri // 16).reshape(1),
                         torch.full((1,), -1, dtype=c16.dtype))
    nb2 = N // 16 + 1
    nb1 = N // 256 + 1
    npad2 = nb1 * 16
    c16p = torch.zeros((npad2, 4), dtype=torch.int64)
    c16p[: c16.shape[0]] = c16
    grp = c16p.reshape(nb1, 16, 4)
    occ2 = (torch.cumsum(grp, dim=1) - grp).reshape(npad2, 4)[:nb2].to(
        torch.int32)
    sup_tot = grp.sum(dim=1)
    occ1 = (torch.cumsum(sup_tot, dim=0) - sup_tot)[:nb1]
    totals = sup_tot.sum(dim=0)
    cnt = torch.cumsum(totals, dim=0) - totals + 1
    reps = torch.repeat_interleave(occ1, 16, dim=0)[:nb2]
    occf = reps + occ2.to(torch.int64)
    lw = torch.zeros(nb2, dtype=torch.int64)
    k = min(W, nb2)
    lw[:k] = pack.as_u32(words[:k])
    lf = pack.to_u32_bits(torch.cat([occf, lw[:, None]], dim=1))
    return occ1, occ2, lf, totals, cnt


def _frozen_block(row0, N, bwt, sa, occ_off):
    """block_counts' and block_tables' occ tables, and the block's counts
    that build_index_rows added to its offset."""
    gidx = row0 + torch.arange(bwt.shape[0], dtype=torch.int64)
    words = pack.pack_dibits_u32(bwt)
    starts = torch.arange(words.shape[0], dtype=torch.int64) * 16 + row0
    cut = torch.clamp(N - torch.clamp(starts, max=N), 0, 16)
    c16 = torch.stack(
        [pack.count_symbol_prefix(words, c, cut) for c in range(4)], dim=1)
    is_pri = (gidx < N) & (sa == 0)
    c16[:, 0] -= is_pri.reshape(-1, 16).sum(dim=1)
    g = c16.reshape(-1, 16, 4)
    sup_tot = g.sum(dim=1)
    occ2 = (torch.cumsum(g, dim=1) - g).reshape(-1, 4)
    occ1 = torch.cumsum(sup_tot, dim=0) - sup_tot + occ_off
    lf = torch.cat([torch.repeat_interleave(occ1, 16, dim=0) + occ2,
                    pack.as_u32(words)[:, None]], dim=1)
    return occ1, occ2.to(torch.int32), pack.to_u32_bits(lf), c16.sum(dim=0)


# N on both sides of 16, 256 and 65,536 and their multiples
ROWS = [1, 2, 15, 16, 17, 255, 256, 257, 4096, 4097, 65535, 65536, 65537,
        3 * 65536 + 4000]
PLACES = ["first", "middle", "last"]


def _pri(N: int, place: str) -> int:
    if place == "first":
        return min(5, N - 1)
    if place == "last":
        return N - 1
    mid = (N // 512) * 256 + 100  # inside a middle superblock
    return mid if mid < N else N // 2


@pytest.mark.parametrize("place", PLACES)
@pytest.mark.parametrize("N", ROWS)
def test_plain_is_the_whole_builds_expressions(N, place):
    pri = _pri(N, place)
    words = bwt_words(N, pri, seed=N)
    pri_t = torch.tensor(pri, dtype=torch.int64)
    zero = torch.zeros(4, dtype=torch.int64)
    got = fm.occ_tables_plain(words, N, pri_t, zero)
    occ1, occ2, lf, totals, cnt = _frozen_whole(words, N, pri_t)
    assert got.occ1.dtype == torch.int64 and torch.equal(got.occ1, occ1)
    assert got.occ2.dtype == torch.int32 and torch.equal(got.occ2, occ2)
    assert got.lf_tab.dtype == torch.int32 and torch.equal(got.lf_tab, lf)
    assert torch.equal(got.totals, totals)
    assert torch.equal(torch.cumsum(got.totals, 0) - got.totals + 1, cnt)
    # what FMIndex.load fuses from the archive's occ1 and occ2
    assert torch.equal(fm._fuse_lf_tab(got.occ1, got.occ2, words), lf)
    # the helper on a CPU tensor is the plain version
    via = fm.occ_tables(words, N, pri_t, zero)
    for a, b in zip(via, got):
        assert torch.equal(a, b)


# (row0, B, N, the sentinel's row or None): a block inside the rows, one
# that N cuts (at, before and after a 16-row word's end), one wholly past
# N, and blocks with the sentinel at their first, middle and last row
BLOCKS = [
    (0, 4096, 10_000, 7),
    (4096, 4096, 10_000, None),
    (8192, 4096, 10_000, 9_999),
    (8192, 4096, 8_192 + 1_600, 8_192 + 1_599),
    (8192, 4096, 8_192 + 1_601, 8_192 + 300),
    (12288, 4096, 10_000, None),
    (65536, 65536, 3 * 65536, 65536),
    (65536, 65536, 3 * 65536, 65536 + 32768 + 100),
    (0, 256, 256, 255),
]


@pytest.mark.parametrize("row0,B,N,pri", BLOCKS)
def test_plain_is_the_block_builds_expressions(row0, B, N, pri):
    g = torch.Generator().manual_seed(row0 + B + N)
    gidx = row0 + torch.arange(B, dtype=torch.int64)
    bwt = torch.randint(0, 4, (B,), dtype=torch.int8, generator=g)
    bwt[gidx >= N] = 0  # pads: symbol 0, SA 1
    sa = torch.randint(1, 1 << 40, (B,), generator=g)
    sa[gidx >= N] = 1
    if pri is not None:
        sa[pri - row0] = 0
        bwt[pri - row0] = 0
    occ_off = torch.tensor([2**31 + 7, 123_456, 2**32 - 5, 9])
    counts = fm.block_counts(row0, N, bwt, sa, 4)
    got, totals = fm.block_tables(counts, occ_off, 0)
    occ1, occ2, lf, c16_sum = _frozen_block(row0, N, bwt, sa, occ_off)
    assert torch.equal(got["occ1"], occ1)
    assert torch.equal(got["occ2"], occ2)
    assert torch.equal(got["lf_tab"], lf)
    assert torch.equal(totals, c16_sum)
    assert counts.rows == min(max(N - row0, 0), B)
    assert int(counts.at) == (-1 if pri is None else pri - row0)
    plain = fm.occ_tables_plain(counts.words, counts.rows, counts.at,
                                occ_off, table_rows=B // 16)
    assert torch.equal(plain.totals, c16_sum)


def test_occ_tables_refuses_what_it_does_not_take():
    words = bwt_words(100, 3, seed=1)
    pri, off = torch.tensor(3), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="rows"):
        fm.occ_tables(words, 16 * words.shape[0] + 1, pri, off)
    with pytest.raises(ValueError, match="table_rows"):
        fm.occ_tables(words, 100, pri, off, table_rows=words.shape[0] - 1)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fm.occ_tables(words.to("meta"), 100, pri.to("meta"), off.to("meta"))


def _fmi(idx) -> bytes:
    buf = io.BytesIO()
    idx.save(buf)
    return buf.getvalue()


# N = 5001; N = 4096 (a multiple of 16, 64 and 256); N = 65,536; and an
# index that samples every row
@pytest.mark.parametrize("n,sa_intv", [(5000, 4), (4095, 4), (65535, 4),
                                       (5000, 1)],
                         ids=["5000", "4095", "65535", "5000-sa_intv1"])
def test_three_builders_write_kiss_tpus_fmi(n, sa_intv):
    text = oracle.repeat_heavy_dna(n, unit=41, seed=n)
    N = n + 1
    sa = k_ordered_suffix_array(text, -1, device="cpu")
    j = jfm.FMIndex(sa_intv=sa_intv, lookup_len=0).build(text, sa=sa)
    j.full_sa = False
    want = _fmi(j)
    whole = fm.FMIndex(sa_intv=sa_intv, lookup_len=0, device="cpu").build(
        text, sa=sa)
    whole.full_sa = False
    assert _fmi(whole) == want
    for block_rows in (1000, 4097, 1 << 20):
        rows = fm.FMIndex(sa_intv=sa_intv, lookup_len=0,
                          device="cpu").build_rows(
            text, sa, full_sa=False, block_rows=block_rows)
        assert _fmi(rows) == want, block_rows
    mesh = fm.trim_canonical(
        fm_build.build_index_sharded(make_mesh(3, device="cpu"), text,
                                     torch.from_numpy(sa.astype(np.int64)),
                                     sa_intv), N, sa_intv)
    assert _fmi(fm.FMIndex(sa_intv=sa_intv, lookup_len=0, arrays=mesh,
                           n_rows=N, device="cpu")) == want

"""The port's chm13-scale route at a small size, on the CPU:

- the row-blocked index build (``fm_index.build_index_rows``,
  ``FMIndex.build_rows``) against ``kiss_tpu``'s build (every table, the
  ``.fmi`` bytes, at sa_intv 1, 2, 4 and 8) and the port's one-block
  build, at block sizes that cross the 16-, 64- and 256-row
  boundaries;
- the readers of tables that hold uint32 bits, on tables whose values lie
  in [2**31, 2**32): ``save`` -> ``load`` and the widening of ``lf_tab``
  and ``b_tab``, nothing sign-extended;
- K1's key range (N < 2**32, for the kernel's wrapper and the plain
  version) on meta tensors, its pass plan on unsigned counts of 2**31 or
  more, ``_compact_rows`` in chunks, and the sort checks of
  ``utils.checks``;
- ``experiments.chm13_full``'s rehearsal (``--device cpu -n 200000``)
  with all its checks.

Every comparison is exact (integers, tolerance 0)."""

import io

import numpy as np
import pytest
import torch

from kiss_tpu.models import fm_index as jfm
from kiss_tpu_torch.experiments import chm13_full
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import radix_sort, suffix_sort
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.utils import checks
from tests import oracle

torch.set_num_threads(1)


def _save(idx) -> bytes:
    buf = io.BytesIO()
    idx.save(buf)
    return buf.getvalue()


# n = 5000, and n = 4095: N = 4096, a multiple of 16, 64 and 256
@pytest.fixture(scope="module", params=[5000, 4095], ids=["n5000", "N4096"])
def case(request):
    """(text, its 32-ordered SA as the out-of-core sorter returns it:
    uint32 numpy, kiss_tpu's index of them, its .fmi bytes)."""
    n = request.param
    text = oracle.repeat_heavy_dna(n, unit=37, seed=n)
    sa = k_ordered_suffix_array(text, 32, device="cpu")
    j = jfm.FMIndex(sa_intv=4, lookup_len=0).build(text, sa=sa)
    j.full_sa = False
    return text, sa, j, _save(j)


@pytest.mark.parametrize("block_rows", [1, 63, 1000, 4097, 1 << 20])
def test_blocked_build_equals_kiss_tpu_and_whole_build(case, block_rows):
    text, sa, j, j_bytes = case
    t = fm.FMIndex(sa_intv=4, lookup_len=0, device="cpu").build_rows(
        text, sa, full_sa=False, block_rows=block_rows)
    want = fm.arrays_from_numpy(
        {k: np.asarray(v) for k, v in j.arrays._asdict().items()}, "cpu")
    whole = fm.build_index_device(torch.from_numpy(text),
                                  torch.from_numpy(sa.astype(np.int64)), 4)
    for name in fm.FMArrays._fields:
        got = getattr(t.arrays, name)
        assert torch.equal(got, getattr(whole, name)), name
        ref = getattr(want, name)  # kiss_tpu's pri has one dimension
        assert got.dtype == ref.dtype and torch.equal(
            got.reshape(ref.shape), ref), name
    assert _save(t) == j_bytes
    w = fm.FMIndex(sa_intv=4, lookup_len=0, device="cpu").build(text, sa=sa)
    assert _save(w) == j_bytes


@pytest.mark.parametrize("sa_intv", [1, 2, 8])
def test_blocked_build_other_sampling(case, sa_intv):
    text, sa, _, _ = case
    j = jfm.FMIndex(sa_intv=sa_intv, lookup_len=0).build(text, sa=sa)
    want = fm.arrays_from_numpy(
        {k: np.asarray(v) for k, v in j.arrays._asdict().items()}, "cpu")
    # the SA as a tensor of uint32 bits, as a card holds it
    sa_bits = torch.from_numpy(sa.view(np.int32))
    for got in (fm.build_index_rows(torch.from_numpy(text), sa_bits,
                                    sa_intv, 777),
                fm.build_index_device(torch.from_numpy(text),
                                      torch.from_numpy(sa.astype(np.int64)),
                                      sa_intv)):
        for name in fm.FMArrays._fields:
            ref = getattr(want, name)  # kiss_tpu's pri has one dimension
            assert torch.equal(getattr(got, name).reshape(ref.shape),
                               ref), name


def test_blocked_build_rejects_a_short_sa(case):
    text, sa, _, _ = case
    with pytest.raises(ValueError, match="rows"):
        fm.build_index_rows(torch.from_numpy(text), sa[:-1], 4)


BIG = 2**31 + 12_345  # added to every count, row and position


def test_u32_tables_save_load_and_widen_without_sign_extension():
    """Tables whose entries lie in [2**31, 2**32): the ``.fmi`` round trip
    keeps cnt, occ1, sa_samp and b_occ, and the readers of ``lf_tab`` and
    ``b_tab`` (their int32 storage negative there) widen to the values."""
    text = oracle.random_dna(3_000, seed=31)
    idx = fm.FMIndex(sa_intv=4, lookup_len=0, device="cpu").build(
        text, sort_len=32)
    a = idx.arrays
    big = a._replace(cnt=a.cnt + BIG, occ1=a.occ1 + BIG,
                     sa_samp=a.sa_samp + BIG, b_occ=a.b_occ + BIG)
    big = big._replace(lf_tab=fm._fuse_lf_tab(big.occ1, big.occ2,
                                              big.bwt_words),
                       b_tab=fm._fuse_b_tab(big.b_occ, big.b_words))
    assert int(big.lf_tab[:, :4].min()) < 0  # stored bits past 2**31
    idx.arrays = big
    back = fm.FMIndex(sa_intv=4, device="cpu").load(io.BytesIO(_save(idx)))
    for name in ("cnt", "occ1", "sa_samp", "b_occ", "lf_tab", "b_tab"):
        got, want = getattr(back.arrays, name), getattr(big, name)
        assert torch.equal(got, want), name
    for name in ("cnt", "occ1", "sa_samp", "b_occ"):
        assert int(getattr(back.arrays, name).min()) >= 2**31, name
    N = len(text) + 1
    rows = torch.arange(N + 1, dtype=torch.int64)
    assert torch.equal(fm._lf_all4(big, rows), fm._lf_all4(a, rows) + 2 * BIG)
    inside = rows[: big.b_tab.shape[0] * fm.B_OCC_INTV]
    assert torch.equal(fm._b_rank(big, inside), fm._b_rank(a, inside) + BIG)
    small, wide = fm.block_table(a, 4), fm.block_table(big, 4)
    assert torch.equal(wide.blk, small.blk)  # counts within a superblock
    assert torch.equal(wide.sup[:, :4], small.sup[:, :4] + 2 * BIG)
    assert torch.equal(wide.sup[:, 4], small.sup[:, 4] + BIG)


def test_radix_sort_takes_keys_below_2_32():
    """The key range of K1's wrapper and plain version, on meta tensors
    (shapes only): N = 2**31 + 4096 is taken (the plain version sorts it,
    the wrapper reaches its device dispatch), N = 2**32 is refused."""
    ok = torch.empty((1, 2**31 + 4096), dtype=torch.int32, device="meta")
    s, p = radix_sort.radix_sort_words_plain(ok)
    assert s.shape == ok.shape and p.shape == (2**31 + 4096,)
    with pytest.raises(ValueError, match="unsupported device meta"):
        radix_sort.radix_sort_words(ok)
    too_many = torch.empty((1, 2**32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="N < 2\\*\\*32"):
        radix_sort.radix_sort_words(too_many)


def test_pass_plan_on_counts_of_2_31_or_more():
    """Digit counts of 2**31 or more, as the card's int32 counts read as
    uint32: a byte whose keys all share one digit needs no pass."""
    n = 2**31 + 4096
    counts = np.zeros((1, 4, 256), dtype=np.uint32)
    counts[0, :, 0] = n  # every byte constant ...
    counts[0, 1, 0], counts[0, 1, 7] = n - 5, 5  # ... but byte 1
    assert radix_sort.pass_plan(counts, n) == [radix_sort.DigitPass(0, 1,
                                                                    None)]
    signed = counts.view(np.int32)  # what a sign-extending read would see
    assert len(radix_sort.pass_plan(signed, n)) == 4


@pytest.mark.parametrize("chunk", [1, 37, 500, 2_000])
def test_compact_rows_in_chunks(monkeypatch, chunk):
    """Every set flag's id, ascending, whatever the chunk the flags are
    read in (one chunk, several, a last one cut short)."""
    monkeypatch.setattr(suffix_sort, "_COMPACT_CHUNK", chunk)
    rng = np.random.default_rng(chunk)
    flags = rng.random(10_007) < 0.05
    got = suffix_sort._compact_rows(torch.from_numpy(flags))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.flatnonzero(flags))


def test_stable_sort_and_permutation_checks():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(
        rng.integers(0, 8, (2, 3_000)).astype(np.uint32).view(np.int32))
    keys[0, ::7] = -1  # 0xFFFFFFFF: past 2**31 as uint32
    s, p = radix_sort.radix_sort_words(keys)
    checks.check_stable_sort(keys, s, p, chunk=257)
    # equal neighbours swapped: the keys still match, the order does not
    i = int(torch.nonzero((s[:, 1:] == s[:, :-1]).all(dim=0))[0])
    q = p.clone()
    q[[i, i + 1]] = q[[i + 1, i]]
    with pytest.raises(RuntimeError, match="position order"):
        checks.check_stable_sort(keys, keys[:, q], q, chunk=257)
    dup = p.clone()
    dup[0] = dup[1]
    with pytest.raises(RuntimeError, match="permutation"):
        checks.check_permutation(dup, chunk=100)


def test_chm13_rehearsal_on_the_cpu(tmp_path, capsys):
    results = tmp_path / "results.md"
    rc = chm13_full.main([
        "--device", "cpu", "-n", "200000", "--workdir", str(tmp_path / "w"),
        "--incore-n", "300000", "--compact-n", "300000", "--pairs", "200000",
        "--results", str(results),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "in-core seed sort on cpu" in out
    text = results.read_text()
    assert "bit-exact" in text and "at exactly the oracle's positions" in text
    # a second run resumes from the text and SA checkpoints
    rc = chm13_full.main([
        "--device", "cpu", "-n", "200000", "--workdir", str(tmp_path / "w"),
        "--skip-incore", "--compact-n", "1000", "--pairs", "1000",
        "--results", str(results),
    ])
    assert rc == 0
    assert "load SA checkpoint" in results.read_text()

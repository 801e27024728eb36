"""The port's sample sort (``kiss_tpu_torch.parallel.ssort``) on CPU
shards: the clean path bit-identical to the single-device sort, the
overflow contract (``SampleSortOverflow`` raised by the block sort, the
facade and the suffix-sort pipeline), the int32 row guard, and the unsigned splitter rank against a numpy count. It does
not run kiss_tpu's sample sort, whose cases take minutes on the CPU
(``tests/test_ssort.py``); the port's single-device sort is held against
kiss_tpu elsewhere."""

import numpy as np
import pytest
import torch

from kiss_tpu_torch.ops.radix_sort import radix_sort_wide
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.parallel import dsort, make_mesh, ssort
from tests import oracle

torch.set_num_threads(1)


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32))


def test_lex_less_count_unsigned():
    """Rows strictly less than each splitter, by an unsigned W-word
    compare: values at and above 2**31 (negative as int32) included."""
    rng = np.random.default_rng(0)
    B, W, T = 600, 3, 9
    vals = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    ops = vals[rng.integers(0, 5, (W, B))]
    spl = vals[rng.integers(0, 5, (W, T))]
    rows = [tuple(r) for r in ops.T]
    for t in range(T):
        want = sum(1 for r in rows if r < tuple(spl[:, t]))
        assert int(ssort._lex_less_count(_u32(ops), _u32(spl), t)) == want


def test_sizes_invariants():
    """The facade's blocks hold B >= 2D rows (B % 2D == 0); a block under
    that leaves no room for the drift bound."""
    for B, D in [(1000, 8), (4096, 4), (64, 2), (16, 8), (4, 2)]:
        C, M, S = ssort._sizes(B, D)
        assert M == C * D and S == M - B and 0 < S <= B
    with pytest.raises(ValueError, match="B >= 2D"):
        ssort._sizes(1, 8)


@pytest.mark.parametrize("D", [2, 3, 4, 8])
@pytest.mark.parametrize("n,w", [(37, 1), (4096, 2), (5000, 5),
                                 (30_000, 9)])
def test_clean_path_equals_single_device(D, n, w):
    """Random keys with many ties, and pre-sorted keys (device 0's block
    the lowest bucket without the decorrelating deal)."""
    rng = np.random.default_rng(n + w)
    impl = dsort.make_sharded_sort_impl(make_mesh(D, device="cpu"), "sample")
    for keys in (_u32(rng.integers(0, 50, (w, n))),
                 _u32(np.tile(np.arange(n), (w, 1)))):
        got = impl(keys)
        want = radix_sort_wide(keys)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sample_pipeline_equals_single_device():
    """The whole k-ordered suffix sort with every sort a sample sort."""
    text = oracle.repeat_heavy_dna(10_000, unit=13, seed=3)
    for k, D in ((256, 4), (-1, 3)):
        got = dsort.sharded_k_ordered_suffix_array(
            make_mesh(D, device="cpu"), text, k, algorithm="sample")
        np.testing.assert_array_equal(
            got.numpy(), k_ordered_suffix_array(text, k, device="cpu"))


def test_overflow_poisons_and_flags():
    """Keys aligned with the deal's residue classes: after the deal shard
    c holds only key value c, so its whole block lands in one bucket,
    over the capacity. The block sort raises SampleSortOverflow before
    its exchange, and so does the facade's sort; the input is left as it
    was."""
    D, n = 4, 4096
    mesh = make_mesh(D, device="cpu")
    i = np.arange(n)
    full = _u32(np.stack([i % D, i]))
    with pytest.raises(dsort.SampleSortOverflow):
        ssort.block_sample_sort(mesh, mesh.split(full))
    keys = _u32((i % D)[None, :])
    before = keys.clone()
    with pytest.raises(dsort.SampleSortOverflow):
        dsort.make_sharded_sort_impl(mesh, "sample")(keys)
    assert torch.equal(keys, before)


def test_overflow_raises_through_the_pipeline():
    """A text of period D: the seed keys of the positions shard c holds
    after the deal are all equal, so the first sort overflows and the
    pipeline raises SampleSortOverflow instead of returning an SA."""
    text = np.tile(np.arange(4, dtype=np.int8), 2000)
    with pytest.raises(dsort.SampleSortOverflow):
        dsort.sharded_k_ordered_suffix_array(
            make_mesh(4, device="cpu"), text, 64, algorithm="sample")
    sa = dsort.sharded_k_ordered_suffix_array(
        make_mesh(4, device="cpu"), text, 64)  # columnsort: no sampling
    np.testing.assert_array_equal(
        sa.numpy(), k_ordered_suffix_array(text, 64, device="cpu"))


def test_int32_row_guard():
    """A padded N of 2**31 or more is rejected before any data is
    touched (an expanded view: no 8 GB allocation)."""
    impl = dsort.make_sharded_sort_impl(make_mesh(8, device="cpu"), "sample")
    big = torch.zeros((1, 1), dtype=torch.int32).expand(1, 2**31 + 8)
    with pytest.raises(ValueError, match="int32"):
        impl(big)

"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1 ``radix_sort_words``, K2 ``fm_backward_search``
(``get_range_packed_device``), K3 ``fm_locate_rows`` / ``fm_locate_stats``
(``locate_rows_device`` / ``batch_locate_stats_device``). All outputs
are integers, so every comparison is exact (tolerance 0).

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false. On a machine with a
card (and no JAX, which the root conftest imports):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops.radix_sort import (
    radix_sort_words,
    radix_sort_words_plain,
)
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, w, n, high=2**32):
    keys = rng.integers(0, high, (w, n), dtype=np.uint64)
    return torch.from_numpy(keys.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize(
    "w,n,high",
    [(1, 1, 2**32), (1, 4097, 2**32), (5, 2049, 2**32), (8, 100_003, 2**32),
     (9, 70_000, 2**32), (5, 50_000, 4), (3, 40_000, 1)],
)
def test_radix_sort_words_matches_plain(cuda, w, n, high):
    keys = _words(np.random.default_rng(n + w), w, n, high).to(cuda)
    got_k, got_p = radix_sort_words(keys)
    want_k, want_p = radix_sort_words_plain(keys)
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p)  # stable: the identical permutation
    assert torch.equal(got_k, want_k)


def test_radix_sort_words_stable_payload(cuda):
    """Many equal keys: the payload must come out in input order within
    each tie (the tail refinement's contract)."""
    rng = np.random.default_rng(5)
    keys = _words(rng, 8, 30_000, 3).to(cuda)
    payload = torch.from_numpy(rng.permutation(30_000)).to(cuda)
    _, perm = radix_sort_words(keys)
    order = np.lexsort(
        [np.arange(30_000)]
        + [keys[i].cpu().numpy().view(np.uint32) for i in range(7, -1, -1)]
    )
    assert torch.equal(payload[perm].cpu(), payload.cpu()[order])


@pytest.fixture(scope="module")
def index_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tests import oracle

    text = oracle.repeat_heavy_dna(1 << 16, unit=300, seed=1)
    idx = {}
    for L in (0, 4):
        f = fm.FMIndex(sa_intv=4, lookup_len=L, device="cuda").build(text)
        idx[L] = f
    return text, idx


@pytest.mark.parametrize("qlen", [12, 25])
@pytest.mark.parametrize("lookup_len", [0, 4])
@pytest.mark.parametrize("early_stop", [True, False])
def test_backward_search_matches_plain(index_pair, qlen, lookup_len,
                                       early_stop):
    text, idx = index_pair
    arrays = idx[lookup_len].arrays
    rng = np.random.default_rng(qlen)
    starts = rng.integers(0, len(text) - qlen, 3000)
    queries = text[starts[:, None] + np.arange(qlen)[None, :]]
    queries[::10] = rng.integers(0, 4, (300, qlen))
    qw = torch.from_numpy(
        pack.np_pack_queries_2bit(queries).view(np.int32)
    ).cuda()
    got = fm.get_range_packed_device(arrays, qw, qlen, lookup_len, early_stop)
    want = fm.get_range_packed_device_plain(arrays, qw, qlen, lookup_len,
                                            early_stop)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_locate_rows_and_stats_match_plain(index_pair):
    text, idx = index_pair
    f = idx[0]
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(0, len(text) + 1, 20_000)).cuda()
    assert torch.equal(
        fm.locate_rows_device(f.arrays, rows, 4),
        fm.locate_rows_device_plain(f.arrays, rows, 4),
    )
    queries = text[rng.integers(0, len(text) - 12, 2000)[:, None]
                   + np.arange(12)[None, :]]
    qw = torch.from_numpy(pack.np_pack_queries_2bit(queries).view(np.int32))
    beg, end, _ = fm.get_range_packed_device(f.arrays, qw.cuda(), 12, 0)
    assert fm.batch_locate_stats_device(f.arrays, beg, end, 4) == (
        fm.batch_locate_stats_device_plain(f.arrays, beg, end, 4)
    )


def test_sa_on_card_equals_cpu(cuda):
    from tests import oracle

    text = oracle.repeat_heavy_dna(40_000, unit=700, seed=2)
    for k in (256, -1):
        np.testing.assert_array_equal(
            k_ordered_suffix_array(text, k, device="cuda"),
            k_ordered_suffix_array(text, k, device="cpu"),
        )

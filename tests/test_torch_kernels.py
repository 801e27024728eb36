"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1 ``radix_sort_words``, K2 ``fm_backward_search``
(``get_range_packed_device``), K3 ``fm_locate_rows`` / ``fm_locate_stats``
(``locate_rows_device`` / ``batch_locate_stats_device``), and the seven
probes P1-P7 of ``kiss_tpu_torch.experiments``. All outputs are integers,
so every comparison is exact (tolerance 0).

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false. On a machine with a
card (and no JAX, which the root conftest imports):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.experiments import micro_copy, micro_kernels
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


# ---------------------------------------------------------------- P1-P7


def _probe_pair(cuda, R, seed, high=2**32):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, high, (R, 128), dtype=np.uint64).astype(np.uint32)
    v = rng.integers(-2**31, 2**31, (R, 128), dtype=np.int64).astype(np.int32)
    return (torch.from_numpy(k.view(np.int32)).to(cuda),
            torch.from_numpy(v).to(cuda))


def _counted(name, fn, *args):
    """fn(*args) on the card, synchronized, having launched ``name`` once."""
    before = kernels.LAUNCHES[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


# The elementwise template moves a tile in batches of 4 vectors a thread
# (128 rows a batch of 1024 threads, 64 of 512), or, for copy_grid with
# fewer tiles than SMs, through a ring of 6 stages of 16 KB (32 rows a
# stage, 192 rows the ring). Shapes on the edges of those: a tile smaller
# than a stage (8 rows), of exactly one stage (32) and one row more (33),
# of the ring and one row more (192, 193), many times the ring (2048), a
# ragged last tile (5000 / 512, 1000 / 193), a tile larger than the array
# (300 / 1000), 1-row tiles, a row more than a batch (129), and far more
# tiles than blocks resident at once (4096, 607, 2000, 256).
TILE_MAP_SHAPES = [
    (32, 8), (4096, 2048), (5000, 512), (32, 32), (96, 32), (99, 33),
    (384, 192), (386, 193), (1000, 193), (300, 1000), (4096, 1), (20000, 33),
    (64000, 32), (33000, 129),
]


@pytest.mark.parametrize("R,rows", TILE_MAP_SHAPES)
def test_stream_copy_matches_plain(cuda, R, rows):
    x, _ = _probe_pair(cuda, R, R)
    got = _counted("stream_copy", micro_kernels.stream_copy, x, rows)
    assert torch.equal(got, micro_kernels.stream_copy_plain(x, rows))


@pytest.mark.parametrize(
    "R,rows,d,stage_d",
    [(64, 8, 1, 1), (64, 8, 512, 512), (4096, 2048, 128, 128),
     (4096, 2048, 1 << 16, 1 << 16), (96, 24, 4, 2)],
)
@pytest.mark.parametrize("high", [2**32, 4])
def test_one_stage_matches_plain(cuda, R, rows, d, stage_d, high):
    k, v = _probe_pair(cuda, R, d, high)
    got = _counted("one_stage", micro_kernels.one_stage, k, v, rows, d,
                   stage_d)
    want = micro_kernels.one_stage_plain(k, v, rows, d, stage_d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("R,rows", [(16, 1), (64, 16), (512, 64), (1024, 256),
                                    (4096, 2048)])
@pytest.mark.parametrize("high", [2**32, 4])
def test_tile_sort_matches_plain(cuda, R, rows, high):
    k, v = _probe_pair(cuda, R, rows, high)
    got = _counted("tile_sort", micro_kernels.tile_sort, k, v, rows)
    want = micro_kernels.tile_sort_plain(k, v, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("entries", [1, 1000, 1 << 15, 58_112, 58_113,
                                     1 << 16])
def test_kernel_gather_matches_plain(cuda, entries):
    """Tables on both sides of the shared-memory limit (58,112 entries)."""
    table, _ = _probe_pair(cuda, -(-entries // 128), entries)
    table = table.reshape(-1)[:entries]
    g = torch.Generator(device=cuda).manual_seed(entries)
    idx = torch.randint(0, entries, (3000, 128), dtype=torch.int32,
                        device=cuda, generator=g)
    got = _counted("kernel_gather", micro_kernels.kernel_gather, table, idx,
                   512)
    assert torch.equal(got, micro_kernels.kernel_gather_plain(table, idx, 512))


@pytest.mark.parametrize("entries", [1000, 1 << 16])
def test_kernel_gather_clamps_bad_indices(cuda, entries):
    """No index makes the kernel read outside the table: one past the end,
    or negative (a large unsigned number), reads the last entry."""
    table, _ = _probe_pair(cuda, -(-entries // 128), 9)
    table = table.reshape(-1)[:entries]
    idx = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    idx[0, :4] = torch.tensor([entries, -1, 2**31 - 1, entries - 1],
                              dtype=torch.int32)
    got = _counted("kernel_gather", micro_kernels.kernel_gather, table, idx, 8)
    assert got[0, :4].tolist() == [int(table[-1])] * 4
    assert bool((got.reshape(-1)[4:] == table[0]).all())


@pytest.mark.parametrize("R,rows", TILE_MAP_SHAPES)
def test_copy_grid_and_heavy_match_plain(cuda, R, rows):
    x, _ = _probe_pair(cuda, R, R + 1)
    got = _counted("copy_grid", micro_copy.copy_grid, x, rows)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    got = _counted("run_heavy", micro_copy.run_heavy, x, rows)
    assert torch.equal(got, micro_copy.run_heavy_plain(x, rows))


@pytest.mark.parametrize("probe", ["copy_grid", "stream_copy", "run_heavy"])
@pytest.mark.parametrize("extra_vec", [1, -1, 0])
def test_tile_map_tile_of_ring_size_and_16_bytes(cuda, probe, extra_vec):
    """A tile of the ring's 6 x 1024 vectors and one 16-byte vector more
    (or less, or none): finer than any whole number of rows, so straight
    through the library's entry point; the array is 5 such tiles and a
    ragged sixth."""
    tile_vec = 6 * 1024 + extra_vec
    x, _ = _probe_pair(cuda, 1000, 17)
    out = torch.empty_like(x)
    fn, plain, scalars = {
        "copy_grid": (kernels.library().kt_probe_copy_grid,
                      micro_copy.copy_grid_plain, ()),
        "stream_copy": (kernels.library().kt_probe_stream_copy,
                        micro_kernels.stream_copy_plain, ()),
        "run_heavy": (kernels.library().kt_probe_heavy,
                      micro_copy.run_heavy_plain,
                      (micro_copy.HEAVY_MUL, micro_copy.HEAVY_ADD)),
    }[probe]
    kernels.check(
        fn(x.data_ptr(), out.data_ptr(), x.numel() // 4, tile_vec, *scalars,
           kernels.stream_of(x.device)),
        probe,
    )
    torch.cuda.synchronize()
    assert torch.equal(out, plain(x, 1))


@pytest.mark.parametrize("R,rows", [(32, 8), (4096, 2048), (4096, 1),
                                    (3000, 24)])
def test_copy_2d_matches_plain(cuda, R, rows):
    x, _ = _probe_pair(cuda, R, R + 2)
    got = _counted("copy_2d", micro_copy.copy_2d, x, rows)
    assert torch.equal(got, micro_copy.copy_2d_plain(x, rows))

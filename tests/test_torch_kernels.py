"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1 ``radix_sort_words``, K5 ``seed_key_words``, K6 ``occ_tables``, K2
``fm_backward_search`` (``get_range_packed_device``), K3 ``fm_locate_rows``
/ ``fm_locate_stats`` (``locate_rows_device`` /
``batch_locate_stats_device``), K4
``fm_bfs_locate`` / ``fm_bfs_stats`` (``bfs_locate_device`` /
``batch_bfs_stats_device``), and the seven probes P1-P7 of
``kiss_tpu_torch.experiments``. All outputs are integers, so every
comparison is exact (tolerance 0).

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false. On a machine with a
card (and no JAX, which the root conftest imports):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.experiments import (
    micro_copy,
    micro_kernels,
    micro_roofline,
)
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops.radix_sort import (
    radix_sort_words,
    radix_sort_words_plain,
)
from kiss_tpu_torch.ops.suffix_sort import (
    k_ordered_suffix_array,
    k_ordered_suffix_array_device,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, w, n, high=2**32):
    keys = rng.integers(0, high, (w, n), dtype=np.uint64)
    return torch.from_numpy(keys.astype(np.uint32).view(np.int32))


# The pass kernel's tile is 8192 keys (512 threads x 16): N on both sides
# of one tile and of two, and many tiles.
RADIX_TILE = 8192


def _edge_words(kind, w, n, seed):
    """Key sets that stress the pass kernel: ``random`` (all 32 bits),
    ``small`` (values below 4: long runs of ties), ``equal`` (no pass at
    all), ``two`` (two distinct keys), ``all_but_one`` (one digit holds
    every key but one), ``middle_byte`` (only byte 1 of the middle word
    varies), ``skip_word`` (a constant word between two sorted ones)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return _words(rng, w, n)
    if kind == "small":
        return _words(rng, w, n, 4)
    keys = np.full((w, n), 0x01020304, dtype=np.uint32)
    if kind == "two":
        keys[:, rng.random(n) < 0.5] = 0xFFFFFFFF
    elif kind == "all_but_one":
        keys[:, n // 2] = 0
    elif kind == "middle_byte":
        keys[w // 2] = 0x01020004 | (
            rng.integers(0, 256, n).astype(np.uint32) << 8
        )
    elif kind == "skip_word":
        keys[0] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        keys[-1] = rng.integers(0, 2**16, n).astype(np.uint32)
    else:
        assert kind == "equal"
    return torch.from_numpy(keys.view(np.int32))


@pytest.mark.parametrize(
    "kind,w,n",
    [("random", 1, 1), ("random", 1, 4097), ("random", 5, 2049),
     ("random", 8, 100_003), ("random", 9, 70_000), ("small", 5, 50_000),
     ("equal", 3, 40_000), ("equal", 1, 1), ("two", 5, 30_000),
     ("two", 1, RADIX_TILE + 1), ("all_but_one", 5, 3 * RADIX_TILE),
     ("all_but_one", 8, RADIX_TILE), ("middle_byte", 5, 50_000),
     ("skip_word", 3, 50_000), ("skip_word", 9, 20_000),
     ("random", 5, RADIX_TILE - 1), ("random", 5, RADIX_TILE),
     ("random", 5, RADIX_TILE + 1), ("small", 8, 2 * RADIX_TILE - 1),
     ("small", 8, 2 * RADIX_TILE), ("small", 8, 2 * RADIX_TILE + 1),
     ("random", 1, 2), ("random", 8, 1_000_003), ("small", 9, 3_000_001),
     ("random", 5, 6_000_000)],
)
def test_radix_sort_words_matches_plain(cuda, kind, w, n):
    keys = _edge_words(kind, w, n, n + w).to(cuda)
    got_k, got_p = radix_sort_words(keys)
    want_k, want_p = radix_sort_words_plain(keys)
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p)  # stable: the identical permutation
    assert torch.equal(got_k, want_k)


def test_radix_sort_words_200_calls_on_two_tiles(cuda):
    """A fault in the look-back between tiles shows as a rare wrong
    answer, not a steady one: 200 sorts in a row of inputs of two tiles
    (and of three with a short last one), each held to the plain version."""
    for call in range(200):
        n = 2 * RADIX_TILE if call % 2 else 2 * RADIX_TILE + 1 + call
        keys = _edge_words("small" if call % 3 else "random", 2, n,
                           call).to(cuda)
        got_k, got_p = radix_sort_words(keys)
        want_k, want_p = radix_sort_words_plain(keys)
        assert torch.equal(got_p, want_p), call
        assert torch.equal(got_k, want_k), call


def test_radix_sort_words_on_the_tensors_card(cuda):
    """K1 launches on the card its keys lie on, whatever card is current:
    keys on cuda:1 while cuda:0 is current (needs two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two visible CUDA devices")
    keys = _edge_words("random", 3, 100_003, 11).to("cuda:1")
    with torch.cuda.device(0):
        got_k, got_p = radix_sort_words(keys)
        torch.cuda.synchronize(keys.device)
    want_k, want_p = radix_sort_words_plain(keys.cpu())
    assert got_k.device == keys.device
    assert torch.equal(got_p.cpu(), want_p)
    assert torch.equal(got_k.cpu(), want_k)


def test_mesh_sorts_on_one_card(cuda):
    """The three mesh sorts with four (and two) shards on one card, every
    local sort K1, against K1 on the whole key set."""
    from kiss_tpu_torch.parallel import dsort, make_mesh

    keys = _edge_words("small", 4, 1_000_003, 12).to(cuda)
    want_k, want_p = radix_sort_words(keys)
    for D, algo in ((4, "columnsort"), (2, "bitonic"), (4, "sample")):
        impl = dsort.make_sharded_sort_impl(make_mesh(devices=[cuda] * D),
                                            algo)
        got_k, got_p = impl(keys)
        assert torch.equal(got_p, want_p), algo
        assert torch.equal(got_k, want_k), algo


def test_blocked_pipeline_on_one_card(cuda):
    """The suffix sort and the build in per-shard blocks, four shards on
    one card: the SA blocks, cut to n + 1, equal the single-device SA
    (every local sort K1), and the host tables the single-device
    build's."""
    from kiss_tpu_torch.parallel import fm_build, make_mesh
    from kiss_tpu_torch.parallel.sharded_plan import sharded_sa_blocks
    from tests import oracle

    text = oracle.repeat_heavy_dna(300_000, unit=900, seed=8)
    mesh = make_mesh(devices=[cuda] * 4)
    for k in (256, -1):
        blocks = sharded_sa_blocks(mesh, text, k)
        assert all(b.device.type == "cuda" for b in blocks)
        np.testing.assert_array_equal(
            mesh.to_host(blocks)[: len(text) + 1],
            k_ordered_suffix_array(text, k, device=cuda))
    tables = fm_build.build_index_blocks(mesh, text, blocks, 4)
    got = fm_build.tables_to_host(
        mesh, tables, fm_build.sharded_lookup(mesh, tables, 0), 4)
    want = fm.FMIndex(sa_intv=4, device=cuda).build(text).arrays
    for name in fm.FMArrays._fields:
        assert torch.equal(getattr(got, name), getattr(want, name).cpu()), name


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


def test_radix_sort_words_on_the_doubling_rounds(cuda):
    """Every K1 launch of the PREFIX_DOUBLING plan at k = 100 and -1 (the
    16-character seed, 2-key rounds of 3 words at N >= 2**21, the k = 100
    round with its raw tail, the tail refinement's 8 words) on a
    tandem-repeat text, against the plain version; the SA equals the wide
    strategy's."""
    from kiss_tpu_torch.ops import suffix_sort as ss
    from tests import oracle

    text = oracle.repeat_heavy_dna((1 << 21) + 5, unit=211, seed=4)
    text_dev = torch.from_numpy(text).to(cuda)
    shapes = set()

    def compared(keys):
        got = radix_sort_words(keys)
        want = radix_sort_words_plain(keys)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        shapes.add(tuple(keys.shape))
        return got

    for k in (100, -1):
        plan = ss._make_plan(len(text), ss._normalize_k(k), pack.DNA,
                             *ss._plan_shape("doubling", pack.DNA))
        sa = ss._run_plan(text_dev, plan, pack.DNA, sort_impl=compared)
        np.testing.assert_array_equal(
            pack.to_u32_bits(sa).cpu().numpy().view(np.uint32),
            k_ordered_suffix_array(text, k, device=cuda))
    assert {w for w, _ in shapes} >= {2, 3, 8}


@pytest.mark.parametrize("w", [1, 2])
def test_packed_torch_sort_equals_k1(cuda, w):
    """``micro_roofline.packed_sort`` (one ``torch.sort`` of the words
    packed into an int64) gives K1's sorted words and permutation: keys
    with the top bit set and ties, and random words."""
    rng = np.random.default_rng(w)
    values = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1],
                      dtype=np.uint64)
    for keys in (
        torch.from_numpy(rng.choice(values, (w, 1_000_003)).astype(
            np.uint32).view(np.int32)),
        _words(rng, w, 3_000_001),
    ):
        keys = keys.to(cuda)
        got = micro_roofline.packed_sort(keys)
        want = radix_sort_words(keys)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_radix_sort_words_past_2_31_keys(cuda):
    """K1 at N = 2**31 + 4096, W = 1: its 32-bit index, digit counts and
    slots past 2**31. 20 bits of each key vary (byte 1 is constant), so
    runs of about 2,000 equal keys cross the 2**31 mark; the output is held
    to the whole stable-sort contract (``utils.checks.check_stable_sort``).
    About 45 GB of the card at the peak."""
    from kiss_tpu_torch.utils.checks import check_stable_sort

    n = 2**31 + 4096
    chunk = 1 << 28
    g = torch.Generator(device=cuda).manual_seed(7)
    keys = torch.empty((1, n), dtype=torch.int32, device=cuda)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        keys[0, lo:hi] = torch.randint(
            -2**31, 2**31 - 1, (hi - lo,), dtype=torch.int32, device=cuda,
            generator=g) & 0x0FFF00FF
    sorted_keys, perm = radix_sort_words(keys)
    torch.cuda.synchronize()
    assert int(perm.max()) == n - 1
    check_stable_sort(keys, sorted_keys, perm)


# ---------------------------------------------------------------- K5


def _seed_text(kind, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed + n)
    high = 4 if kind == "dna" else 256  # "bytes": every value 0..255
    return torch.randint(0, high, (n,), dtype=torch.uint8, device=device,
                         generator=g).view(torch.int8)


@pytest.mark.parametrize("kind", ["dna", "bytes"])
@pytest.mark.parametrize("n", [1, 2, 15, 16, 63, 64, 65, 1000, 4097])
@pytest.mark.parametrize("seed_chars", [1, 15, 16, 17, 32, 48, 63, 64])
def test_seed_key_words_matches_plain(cuda, seed_chars, n, kind):
    text = _seed_text(kind, n, cuda)
    got = pack.seed_key_words(text, seed_chars)
    want = pack.seed_key_words_plain(text, seed_chars)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["dna", "bytes"])
def test_seed_key_words_at_the_sort_cells_shape(cuda, kind):
    """W = 5, N = 48,800,649 (the drosophila chromosome's rows), and the
    text as a slice that starts at an odd byte (the staging's unaligned
    route)."""
    n = 48_800_648
    text = _seed_text(kind, n + 1, cuda)
    for t in (text[:n], text[1:]):
        got = pack.seed_key_words(t, 64)
        want = pack.seed_key_words_plain(t, 64)
        torch.cuda.synchronize()
        assert got.shape == (5, n + 1)
        assert torch.equal(got, want)


def test_seed_key_words_past_2_31_columns(cuda):
    """W = 2 at N = 2**31 + 4097 columns: row 1's offsets pass 2**31 and
    2**32, where 32-bit column indexing would wrap. The plain version holds
    windows of rows: the first, and those across column 2**31 - 4097
    (where row 1 passes word 2**32) and 2**31 to the end. About 20 GB of
    the card."""
    n = 2**31 + 4096
    text = _seed_text("dna", n, cuda)
    got = pack.seed_key_words(text, 16)
    torch.cuda.synchronize()
    assert got.shape == (2, n + 1)
    windows = ((0, 1 << 20), (2**31 - (1 << 20), n + 1 - (2**31 - (1 << 20))))
    for start, rows in windows:
        want = pack.seed_key_words_plain(text[start:], 16, start=start, n=n,
                                         rows=rows)
        assert torch.equal(got[:, start : start + rows], want), start
    del got, text
    torch.cuda.empty_cache()


def test_seed_key_words_raises_on_the_card(cuda):
    """No fallback to the plain version: a CUDA text the kernel does not
    take raises."""
    with pytest.raises(TypeError):
        pack.seed_key_words(torch.zeros(100, dtype=torch.int64, device=cuda),
                            64)
    with pytest.raises(ValueError):
        pack.seed_key_words(torch.zeros((2, 100), dtype=torch.int8,
                                        device=cuda), 64)


def test_sort_launches_k5_once(cuda):
    from tests import oracle

    text = oracle.repeat_heavy_dna(40_000, unit=700, seed=3)
    kernels.reset_launch_counts()
    k_ordered_suffix_array(text, 256, device="cuda")
    assert kernels.LAUNCHES["seed_key_words"] == 1


# ---------------------------------------------------------------- K6


def _occ_words(N, pri, device, seed=0):
    """Random packed BWT words of N rows whose row ``pri`` holds symbol 0,
    as the BWT puts the sentinel; the lanes past N random too."""
    g = torch.Generator(device=device).manual_seed(seed + N)
    w = torch.randint(-2**31, 2**31 - 1, (-(-N // 16),), dtype=torch.int32,
                      device=device, generator=g)
    if 0 <= pri < N:
        keep = ~(3 << (2 * (pri % 16))) & 0xFFFFFFFF
        w[pri // 16] &= keep - ((keep >> 31) << 32)  # as int32 bits
    return w


def _occ_equal(got, want):
    torch.cuda.synchronize()
    for name, a, b in zip(fm.OccTables._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


# row counts on both sides of 16, 256, 65,536 and of K6's 16,384-row tile
OCC_ROWS = [1, 2, 15, 16, 17, 255, 256, 257, 16_383, 16_384, 16_385, 65_535,
            65_536, 65_537, 3 * 65_536 + 4_000, 1_000_003]
OCC_OFFSETS = [(0, 0, 0, 0), (2**31 + 7, 123_456, 2**32 - 5, 9)]


@pytest.mark.parametrize("off", OCC_OFFSETS, ids=["zero", "block"])
@pytest.mark.parametrize("place", ["first", "middle", "last", "none"])
@pytest.mark.parametrize("N", OCC_ROWS)
def test_occ_tables_matches_plain(cuda, N, place, off):
    pri = {"first": min(5, N - 1), "last": N - 1, "none": -1,
           "middle": (N // 512) * 256 + 100 if (N // 512) * 256 + 100 < N
           else N // 2}[place]
    words = _occ_words(N, pri, cuda)
    pri_t = torch.tensor(pri, dtype=torch.int64, device=cuda)
    occ_off = torch.tensor(off, dtype=torch.int64, device=cuda)
    for table_rows in (None, -(-N // 16) + 37):
        got = fm.occ_tables(words, N, pri_t, occ_off, table_rows)
        want = fm.occ_tables_plain(words, N, pri_t, occ_off, table_rows)
        _occ_equal(got, want)


def test_occ_tables_block_form_and_unaligned_words(cuda):
    """The row-blocked builds' form (table rows = words, N cutting the
    block, a sentinel row outside it), and words that start 4 bytes past a
    16-byte boundary (the scalar loads)."""
    words = _occ_words(65_536 * 3, 70_000, cuda, seed=9)
    occ_off = torch.tensor(OCC_OFFSETS[1], dtype=torch.int64, device=cuda)
    # the view words[1:] starts 16 rows on: its row 69,984 is row 70,000
    for w, rows, pri in ((words, 3 * 65_536, 70_000),
                         (words, 100_001, 2**40),
                         (words[1:], 16 * (len(words) - 1) - 3, 69_984)):
        pri_t = torch.tensor(pri, dtype=torch.int64, device=cuda)
        got = fm.occ_tables(w, rows, pri_t, occ_off, table_rows=len(w))
        want = fm.occ_tables_plain(w, rows, pri_t, occ_off,
                                   table_rows=len(w))
        _occ_equal(got, want)


def test_occ_tables_at_the_build_cells_shape(cuda):
    """N = 248,387,329 (the build cell's rows), the sentinel in a middle
    superblock, with no offset and with a block offset whose lf_tab counts
    pass 2**32."""
    N = 248_387_329
    pri = 123_456_789
    words = _occ_words(N, pri, cuda, seed=1)
    pri_t = torch.tensor(pri, dtype=torch.int64, device=cuda)
    for off in OCC_OFFSETS:
        occ_off = torch.tensor(off, dtype=torch.int64, device=cuda)
        got = fm.occ_tables(words, N, pri_t, occ_off)
        want = fm.occ_tables_plain(words, N, pri_t, occ_off)
        _occ_equal(got, want)
        del got, want
    torch.cuda.empty_cache()


def test_occ_tables_raises_on_the_card(cuda):
    """No fallback to the plain version: CUDA inputs the kernel does not
    take raise."""
    words = _occ_words(1000, 3, cuda)
    pri = torch.tensor(3, device=cuda)
    off = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        fm.occ_tables(words.to(torch.int64), 1000, pri, off)
    with pytest.raises(ValueError):
        fm.occ_tables(words, 1000, pri.cpu(), off)
    with pytest.raises(ValueError):
        fm.occ_tables(words, 1000, pri, off[:3])


def test_build_launches_k6_once(cuda):
    from tests import oracle

    text = oracle.repeat_heavy_dna(40_000, unit=700, seed=3)
    kernels.reset_launch_counts()
    fm.FMIndex(sa_intv=4, lookup_len=0, device=cuda).build(text)
    assert kernels.LAUNCHES["occ_tables"] == 1


def test_build_rows_goes_through_k6_on_the_card(cuda):
    """``FMIndex.build_rows`` on the card launches K6 once a block and
    writes the ``.fmi`` bytes of the whole build."""
    import io

    from tests import oracle

    def fmi(idx):
        buf = io.BytesIO()
        idx.save(buf)
        return buf.getvalue()

    text = oracle.repeat_heavy_dna(300_001, unit=97, seed=5)
    sa = k_ordered_suffix_array(text, -1, device=cuda)
    whole = fm.FMIndex(sa_intv=4, lookup_len=0, device=cuda).build(
        text, sa=sa)
    kernels.reset_launch_counts()
    rows = fm.FMIndex(sa_intv=4, lookup_len=0, device=cuda).build_rows(
        text, sa, full_sa=True, block_rows=65_537)
    assert kernels.LAUNCHES["occ_tables"] == -(-len(sa) // 65_537)
    assert fmi(rows) == fmi(whole)


def test_build_rows_equals_whole_build_on_the_card(cuda):
    """The row-blocked build on the card (the SA as uint32 bits there and
    as a host array), blocks crossing every table boundary, against the
    whole-array build."""
    from tests import oracle

    text = oracle.repeat_heavy_dna(300_001, unit=97, seed=3)
    sa = k_ordered_suffix_array(text, 32, device=cuda)
    want = fm.build_index_device(torch.from_numpy(text).to(cuda),
                                 torch.from_numpy(sa.astype(np.int64)).to(cuda),
                                 4)
    for sa_in in (sa, torch.from_numpy(sa.view(np.int32)).to(cuda)):
        got = fm.build_index_rows(torch.from_numpy(text).to(cuda), sa_in, 4,
                                  block_rows=65_537)
        for name in fm.FMArrays._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name


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
    arrays, blocks = idx[lookup_len].arrays, idx[lookup_len].blocks
    rng = np.random.default_rng(qlen)
    starts = rng.integers(0, len(text) - qlen, 3000)
    queries = text[starts[:, None] + np.arange(qlen)[None, :]]
    queries[::10] = rng.integers(0, 4, (300, qlen))
    qw = torch.from_numpy(
        pack.np_pack_queries_2bit(queries).view(np.int32)
    ).cuda()
    got = fm.get_range_packed_device(arrays, qw, qlen, lookup_len, early_stop,
                                     blocks=blocks)
    want = fm.get_range_packed_device_plain(arrays, qw, qlen, lookup_len,
                                            early_stop)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lookup_len", [0, 4])
def test_backward_search_one_query(index_pair, lookup_len):
    """Q = 1 (the -q path), found and absent, unseeded and seeded."""
    text, idx = index_pair
    f = idx[lookup_len]
    for q in (text[1000:1025], np.zeros(25, np.int8)):
        qw = torch.from_numpy(
            pack.np_pack_queries_2bit(q[None, :]).view(np.int32)
        ).cuda()
        got = fm.get_range_packed_device(f.arrays, qw, 25, lookup_len,
                                         blocks=f.blocks)
        want = fm.get_range_packed_device_plain(f.arrays, qw, 25, lookup_len)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_backward_search_lookup_12_matches_plain(index_pair):
    """K2 at the benchmark's lookup-12 shapes over a small index: the
    4**12-seed table build (early stop off), the whole table against the
    plain version's, then a seeded batch of 25-mers (beg, end, offs), whose
    counts are the unseeded ones."""
    text, idx = index_pair
    f, L = idx[0], 12
    seeds = fm.lookup_seed_words(L, "cuda")
    got = fm.get_range_packed_device(f.arrays, seeds, L, 0, early_stop=False,
                                     blocks=f.blocks)
    want = fm.get_range_packed_device_plain(f.arrays, seeds, L, 0,
                                            early_stop=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fl = fm.FMIndex(sa_intv=4, lookup_len=L, arrays=f.arrays,
                    n_rows=f.n_rows, device="cuda", blocks=f.blocks)
    fl._build_lookup()
    n_rows = torch.tensor([f.n_rows], device="cuda")
    assert fl.arrays.lookup.shape == (4**L + 1,)
    assert torch.equal(fl.arrays.lookup, torch.cat([want[0], n_rows]))

    rng = np.random.default_rng(12)
    starts = rng.integers(0, len(text) - 25, 3000)
    queries = text[starts[:, None] + np.arange(25)[None, :]]
    queries[::10] = rng.integers(0, 4, (300, 25))
    qw = torch.from_numpy(
        pack.np_pack_queries_2bit(queries).view(np.int32)
    ).cuda()
    got = fm.get_range_packed_device(fl.arrays, qw, 25, L, blocks=f.blocks)
    want = fm.get_range_packed_device_plain(fl.arrays, qw, 25, L)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    b0, e0, _ = fm.get_range_packed_device(f.arrays, qw, 25, 0,
                                           blocks=f.blocks)
    assert torch.equal(got[1] - got[0], e0 - b0)


def test_locate_rows_and_stats_match_plain(index_pair):
    text, idx = index_pair
    f = idx[0]
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(0, len(text) + 1, 20_000)).cuda()
    assert torch.equal(
        fm.locate_rows_device(f.arrays, rows, 4, blocks=f.blocks),
        fm.locate_rows_device_plain(f.arrays, rows, 4),
    )
    queries = text[rng.integers(0, len(text) - 12, 2000)[:, None]
                   + np.arange(12)[None, :]]
    qw = torch.from_numpy(pack.np_pack_queries_2bit(queries).view(np.int32))
    beg, end, _ = fm.get_range_packed_device(f.arrays, qw.cuda(), 12, 0,
                                             blocks=f.blocks)
    assert fm.batch_locate_stats_device(f.arrays, beg, end, 4,
                                        blocks=f.blocks) == (
        fm.batch_locate_stats_device_plain(f.arrays, beg, end, 4)
    )


def _ranges(pairs):
    beg, end = zip(*pairs)
    return (torch.tensor(beg, dtype=torch.int64, device="cuda"),
            torch.tensor(end, dtype=torch.int64, device="cuda"))


def test_locate_stats_edge_ranges(index_pair):
    """One range, all ranges empty (total 0), a range across the superblock
    boundary at row 65,536 (the index has 65,537 rows), the last row, and
    many empty ranges between long ones (a row's search then passes over
    many ranges that end where it starts)."""
    _, idx = index_pair
    f = idx[0]
    N = f.n_rows
    rng = np.random.default_rng(8)
    lens = np.where(rng.random(5000) < 0.97, 0,
                    rng.integers(1, 3000, 5000))
    starts = rng.integers(0, N - 3000, 5000)
    cases = {
        "one": [(100, 140)],
        "one row": [(N - 1, N)],
        "all empty": [(7, 7)] * 3000,
        "superblock": [(65_000, N), (65_535, 65_537), (0, 1)],
        "sparse": list(zip(starts, starts + lens)),
    }
    for name, pairs in cases.items():
        beg, end = _ranges(pairs)
        got = fm.batch_locate_stats_device(f.arrays, beg, end, 4,
                                           blocks=f.blocks)
        want = fm.batch_locate_stats_device_plain(f.arrays, beg, end, 4)
        assert got == want, name
    assert fm.batch_locate_stats_device(
        f.arrays, *_ranges([(7, 7)] * 3000), 4, blocks=f.blocks) == (0, 0)
    rows = torch.arange(65_400, N, device="cuda")
    assert torch.equal(
        fm.locate_rows_device(f.arrays, rows, 4, blocks=f.blocks),
        fm.locate_rows_device_plain(f.arrays, rows, 4),
    )


@pytest.mark.parametrize("sa_intv", [1, 2])
def test_locate_other_sampling(cuda, sa_intv):
    """sa_intv 1 (sa_samp read directly, no marks) and 2, across a
    superblock."""
    from tests import oracle

    text = oracle.random_dna(70_000, seed=sa_intv)
    f = fm.FMIndex(sa_intv=sa_intv, device="cuda").build(text)
    rows = torch.arange(0, f.n_rows, device="cuda")
    assert torch.equal(
        fm.locate_rows_device(f.arrays, rows, sa_intv, blocks=f.blocks),
        fm.locate_rows_device_plain(f.arrays, rows, sa_intv),
    )
    beg, end = _ranges([(0, 10), (60_000, 70_001), (5, 5)])
    assert fm.batch_locate_stats_device(f.arrays, beg, end, sa_intv,
                                        blocks=f.blocks) == (
        fm.batch_locate_stats_device_plain(f.arrays, beg, end, sa_intv)
    )


def _bfs_cases(f, text, nq, seed):
    """Row ranges of ``f`` for K4: sampled 9-mers (a tenth random), the
    one-symbol ranges (T's ends at row N), one range of a quarter of the
    SA, the whole table, empty ranges, and no range."""
    rng = np.random.default_rng(seed)
    q = text[rng.integers(0, len(text) - 9, nq)[:, None]
             + np.arange(9)[None, :]]
    q[::10] = rng.integers(0, 4, (len(q[::10]), 9))
    b, e, _ = f._ranges(np.ascontiguousarray(q, dtype=np.int8))
    b1, e1, _ = f._ranges(np.arange(4, dtype=np.int8)[:, None])
    N = f.n_rows
    none = torch.empty(0, dtype=torch.int64, device="cuda")
    return {
        "9-mers": (b, e), "one symbol": (b1, e1), "T": (b1[3:], e1[3:]),
        "a quarter": _ranges([(N // 4, N // 2)]), "whole": _ranges([(0, N)]),
        "empty": _ranges([(7, 7)] * 300), "none": (none, none),
    }


def _bfs_match_plain(f, cases):
    for name, (beg, end) in cases.items():
        got = fm.bfs_locate_device(f.arrays, beg, end, f.sa_intv,
                                   blocks=f.blocks)
        want = fm.bfs_locate_device_plain(f.arrays, beg, end, f.sa_intv)
        assert got.device == beg.device and torch.equal(got, want), name
        assert fm.batch_bfs_stats_device(
            f.arrays, beg, end, f.sa_intv, blocks=f.blocks) == (
            fm.batch_bfs_stats_device_plain(f.arrays, beg, end, f.sa_intv)
        ), name


@pytest.mark.parametrize("sa_intv", [2, 4, 8])
@pytest.mark.parametrize("n", [70_000, (1 << 16) - 1])
def test_bfs_matches_plain(cuda, n, sa_intv):
    """K4's locate and stats entry points on 32-ordered indexes across a
    superblock, and at N = 65,536 (N % 64 == 0: an endpoint at row N has
    no b_tab row)."""
    from tests import oracle

    text = oracle.repeat_heavy_dna(n, unit=300, seed=sa_intv)
    f = fm.FMIndex(sa_intv=sa_intv, device="cuda").build(text, sort_len=32)
    assert f._routes_to_bfs()
    _bfs_match_plain(f, _bfs_cases(f, text, 3000 if sa_intv < 8 else 500,
                                   seed=n + sa_intv))


def test_bfs_at_sa_intv_16_against_the_oracle(cuda):
    """sa_intv 16 takes K4's larger stack (9 .. 32), where the plain
    version's widest level, [Q, 4^14, 5], does not fit: each query's
    positions are its occurrences (32 >= 15 + 9: the BFS is exact on a
    32-ordered SA), and the whole table's range gives every position."""
    from tests import oracle

    text = oracle.repeat_heavy_dna(20_000, unit=300, seed=16)
    f = fm.FMIndex(sa_intv=16, device="cuda").build(text, sort_len=32)
    rng = np.random.default_rng(16)
    q = np.stack([text[p : p + 9] for p in rng.integers(0, 20_000 - 9, 40)])
    beg, end, _ = f._ranges(q)
    pos = fm.bfs_locate_device(f.arrays, beg, end, 16, blocks=f.blocks)
    hits = [oracle.search_all(text, x) for x in q]
    starts = np.concatenate([[0], np.cumsum([len(h) for h in hits])])
    pos = pos.cpu().numpy()
    for i, h in enumerate(hits):
        np.testing.assert_array_equal(np.sort(pos[starts[i]:starts[i + 1]]),
                                      h)
    assert fm.batch_bfs_stats_device(f.arrays, beg, end, 16,
                                     blocks=f.blocks) == (
        sum(map(len, hits)), sum(int(h.sum()) for h in hits))
    whole = fm.bfs_locate_device(f.arrays, *_ranges([(0, f.n_rows)]), 16,
                                 blocks=f.blocks)
    np.testing.assert_array_equal(np.sort(whole.cpu().numpy()),
                                  np.arange(f.n_rows))


def test_bfs_100k_ranges_match_plain(index_pair):
    """K4 on 100,000 ranges (the CLI's chunk), the index of a fully
    sorted SA (the BFS is exact on it too)."""
    text, idx = index_pair
    f = idx[0]
    rng = np.random.default_rng(9)
    q = text[rng.integers(0, len(text) - 12, 100_000)[:, None]
             + np.arange(12)[None, :]]
    q[::10] = rng.integers(0, 4, (10_000, 12))
    beg, end, _ = f._ranges(np.ascontiguousarray(q, dtype=np.int8))
    _bfs_match_plain(f, {"100k": (beg, end)})


def test_bfs_spill_route_on_a_mixed_batch(cuda):
    """Ranges of a quarter of the SA among 25-mer ranges: the quarters
    (tree bound 85 > 64 nodes at sa_intv 4) take K4's spill route, the
    25-mers its shared frontier, and both entry points equal their plain
    versions; one quarter alone takes the spill route, as its count
    shows."""
    from tests import oracle

    text = oracle.repeat_heavy_dna(70_000, unit=300, seed=4)
    f = fm.FMIndex(sa_intv=4, device="cuda").build(text, sort_len=32)
    rng = np.random.default_rng(4)
    q = text[rng.integers(0, len(text) - 25, 1000)[:, None]
             + np.arange(25)[None, :]]
    b, e, _ = f._ranges(np.ascontiguousarray(q, dtype=np.int8))
    N = f.n_rows
    at = torch.tensor([3, 300, 301, 999], device="cuda")
    b[at], e[at] = N // 4, N // 2
    kernels.reset_launch_counts()
    _bfs_match_plain(f, {"mixed": (b, e)})
    assert kernels.SPILLED["fm_bfs_locate"] >= 4
    assert kernels.SPILLED["fm_bfs_stats"] >= 4
    kernels.reset_launch_counts()
    _bfs_match_plain(f, {"a quarter": _ranges([(N // 4, N // 2)])})
    assert kernels.SPILLED == {"fm_bfs_stats": 1, "fm_bfs_locate": 1}


def test_bfs_runs_again_at_the_reported_sizes(cuda):
    """Eight whole-table ranges at sa_intv 8 need more pool (8 x 21,845
    nodes) and more segments than the wrappers first give: each entry
    point runs its kernel again at the reported sizes and equals its plain
    version."""
    from tests import oracle

    text = oracle.repeat_heavy_dna(30_000, unit=300, seed=8)
    f = fm.FMIndex(sa_intv=8, device="cuda").build(text, sort_len=32)
    beg, end = _ranges([(0, f.n_rows)] * 8)
    assert fm.bfs_guess(8)[1] < 8 * 21_845
    _bfs_match_plain(f, {"8 x whole": (beg, end)})


def test_bfs_route_launches_k4(cuda):
    """On a card the BFS route of FMIndex (get_offsets, batch_query_stats)
    launches K4's entry points and not K3's, and answers as the oracle."""
    from tests import oracle

    text = oracle.repeat_heavy_dna(20_000, unit=300, seed=3)
    f = fm.FMIndex(sa_intv=4, device="cuda").build(text, sort_len=32)
    q = np.stack([text[p : p + 11] for p in (100, 5000, 12_000)])
    kernels.reset_launch_counts()
    hits = [oracle.search_all(text, x) for x in q]
    assert f.batch_query_stats(q) == (sum(map(len, hits)),
                                      sum(int(h.sum()) for h in hits))
    beg, end, _ = f.get_range(q[0])
    np.testing.assert_array_equal(np.sort(f.get_offsets(beg, end)), hits[0])
    assert kernels.LAUNCHES["fm_bfs_stats"] == 1
    assert kernels.LAUNCHES["fm_bfs_locate"] == 1
    assert kernels.LAUNCHES["fm_locate_stats"] == 0
    assert kernels.LAUNCHES["fm_locate_rows"] == 0


def test_wrappers_need_the_block_table(index_pair):
    """On the card the wrappers launch the kernels, which read the block
    table: without it, or with another index's, they raise, with no
    fallback."""
    _, idx = index_pair
    f = idx[0]
    other = fm.FMIndex(device="cuda").build(np.zeros(100, np.int8)).blocks
    qw = torch.zeros((4, 2), dtype=torch.int32, device="cuda")
    rows = torch.zeros(4, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="blocks"):
        fm.get_range_packed_device(f.arrays, qw, 25, 0)
    with pytest.raises(ValueError, match="block table"):
        fm.get_range_packed_device(f.arrays, qw, 25, 0, blocks=other)
    with pytest.raises(ValueError, match="block table"):
        fm.locate_rows_device(f.arrays, rows, 4, blocks=other)
    with pytest.raises(ValueError, match="block table"):
        fm.batch_locate_stats_device(f.arrays, rows, rows, 4, blocks=other)
    for bfs in (fm.bfs_locate_device, fm.batch_bfs_stats_device):
        with pytest.raises(ValueError, match="block table"):
            bfs(f.arrays, rows, rows, 4)
        with pytest.raises(ValueError, match="block table"):
            bfs(f.arrays, rows, rows, 4, blocks=other)
        with pytest.raises(ValueError, match="sa_intv"):
            bfs(f.arrays, rows, rows, 1, blocks=f.blocks)


def test_sa_on_card_equals_cpu(cuda):
    from tests import oracle

    text = oracle.repeat_heavy_dna(40_000, unit=700, seed=2)
    for k in (256, -1):
        np.testing.assert_array_equal(
            k_ordered_suffix_array(text, k, device="cuda"),
            k_ordered_suffix_array(text, k, device="cpu"),
        )


@pytest.mark.parametrize("strategy", ["wide", "doubling"])
@pytest.mark.parametrize("k", [256, -1])
def test_tied_rounds_equal_whole_array_rounds(cuda, k, strategy):
    """The host path, whose rounds take the rows still tied alone, equals
    the single-program form, every round over the whole array, element
    for element, on a synthetic genome of 2**22 characters (its first
    2**21 are fresh sequence; a few percent of the rows stay tied after
    the wide seed)."""
    from torch.profiler import ProfilerActivity, profile

    from kiss_tpu_torch.utils import timing
    from kiss_tpu_torch.utils.synth import synth_genome

    text = torch.from_numpy(synth_genome(1 << 22, seed=5)).to(cuda)
    timing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = k_ordered_suffix_array(text, k, as_numpy=False, device=cuda,
                                     strategy=strategy)
    tied = sum(r.counts.get("sort_rows_tied", 0) for r in timing.RECORDS)
    timing.reset_spans()
    assert tied > 0  # the compacted path ran
    want = k_ordered_suffix_array_device(text, k, strategy=strategy)
    assert torch.equal(got, want)


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


# T = rows * 128: below a chunk of 8192 elements (128, 2K), one chunk (8K),
# the first sizes that take the wide kernel (16K: one step; 32K), its full
# 5 steps (256K), and two wide launches a merge (512K, 1M).
@pytest.mark.parametrize("R,rows", [(16, 1), (3, 1), (64, 16), (512, 64),
                                    (256, 128), (1024, 256), (4096, 2048),
                                    (8192, 4096), (16384, 8192)])
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

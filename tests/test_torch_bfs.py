"""The port's range BFS (``_lf_all4``, ``bfs_locate_device``,
``batch_bfs_stats_device`` and the ``FMIndex`` routing) against kiss_tpu
on the same index: a JAX-built ``sort_len=32`` index over a repeat-heavy
text, carried across with ``arrays_from_numpy``, so the BFS is held apart
from the build. Every comparison is exact (integers, tolerance 0)."""

import io
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiss_tpu.models import fm_index as jfm
from kiss_tpu.ops import pack as jpack
from kiss_tpu_torch.models import fm_index as tfm
from tests import oracle

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
QLEN = 9  # 32 >= sa_intv - 1 + QLEN (sa_intv <= 8): the BFS is exact on a
# 32-ordered SA


def _np_arrays(fmi):
    return {k: np.asarray(v) for k, v in fmi.arrays._asdict().items()}


@pytest.fixture(scope="module")
def text():
    # unit 40 > 32: the 32-ordered SA leaves long ties in another order
    # than the full sort, which is what breaks the per-row walk
    return oracle.repeat_heavy_dna(6_000, unit=40, seed=8)


@pytest.fixture(scope="module", params=[2, 4, 8],
                ids=["sa_intv2", "sa_intv4", "sa_intv8"])
def bounded(request, text):
    """(sa_intv, JAX index built at sort_len=32, its arrays in the port)."""
    sa_intv = request.param
    j = jfm.FMIndex(sa_intv=sa_intv, lookup_len=0).build(text, sort_len=32)
    assert not j.full_sa
    return sa_intv, j, tfm.arrays_from_numpy(_np_arrays(j), "cpu")


def _queries(text, qlen, seed, nq=80):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - qlen, nq)
    q = text[starts[:, None] + np.arange(qlen)[None, :]]
    q[::5] = rng.integers(0, 4, (len(q[::5]), qlen))  # mostly absent
    return np.ascontiguousarray(q, dtype=np.int8)


def _ranges(j, text, seed):
    q = _queries(text, QLEN, seed)
    qw = jpack.np_pack_queries_2bit(q)
    jb, je, _ = jfm.get_range_packed_device(j.arrays, jnp.asarray(qw), QLEN, 0)
    return q, jb, je


def _t64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_lf_all4_equals_jax(bounded, text):
    _, j, arrays = bounded
    N = len(text) + 1
    pri = int(np.asarray(j.arrays.pri))
    rng = np.random.default_rng(2)
    # the last row N (an endpoint: lf_tab has N // 16 + 1 rows), row 0,
    # the rows around the sentinel, block edges, and random rows
    rows = np.concatenate([
        [0, N, N - 1, pri, pri + 1, max(pri - 1, 0), 15, 16, 17],
        rng.integers(0, N + 1, 501),
    ]).astype(np.int64).reshape(-1, 3)  # a 2-D batch, as the BFS hands it
    want = np.asarray(jfm._lf_all4(j.arrays, jnp.asarray(rows, jnp.int32)))
    got = tfm._lf_all4(arrays, torch.from_numpy(rows))
    assert got.shape == (rows.shape[0], 3, 4)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # and each column is the single-symbol lf the backward search uses
    flat = torch.from_numpy(rows.reshape(-1))
    for c in range(4):
        np.testing.assert_array_equal(
            got.reshape(-1, 4)[:, c].numpy(),
            tfm._lf(arrays, torch.full_like(flat, c), flat).numpy(),
        )


def test_bfs_locate_device_equals_jax_element_for_element(bounded, text):
    sa_intv, j, arrays = bounded
    _, jb, je = _ranges(j, text, 3)
    total = int(jnp.sum(je - jb))
    assert total > 0
    pos, valid = jfm.bfs_locate_device(
        j.arrays, jb, je, sa_intv, jfm._pow2_cap(total, 64)
    )
    assert int(np.asarray(valid).sum()) == total
    got = tfm.bfs_locate_device(arrays, _t64(jb), _t64(je), sa_intv)
    assert got.dtype == torch.int64 and got.shape == (total,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pos[:total]).astype(np.int64)
    )


def test_batch_bfs_stats_device_equals_jax(bounded, text):
    sa_intv, j, arrays = bounded
    _, jb, je = _ranges(j, text, 4)
    total = int(jnp.sum(je - jb))
    lo, hi = jfm.batch_bfs_stats_device(
        j.arrays, jb, je, sa_intv, jfm._pow2_cap(total, 128)
    )
    want = int(np.asarray(lo, np.int64).sum()) + (
        int(np.asarray(hi, np.int64).sum()) << 16
    )
    assert tfm.batch_bfs_stats_device(arrays, _t64(jb), _t64(je), sa_intv) == (
        total, want
    )


def test_bfs_positions_are_the_occurrences(bounded, text):
    """On the 32-ordered index the BFS gives every query's true
    occurrence set (brute-force oracle), grouped query-major."""
    sa_intv, j, arrays = bounded
    q, jb, je = _ranges(j, text, 5)
    beg, end = np.asarray(jb).astype(np.int64), np.asarray(je).astype(np.int64)
    pos = tfm.bfs_locate_device(arrays, _t64(beg), _t64(end), sa_intv).numpy()
    starts = np.concatenate([[0], np.cumsum(end - beg)])
    for qi in range(len(q)):
        np.testing.assert_array_equal(
            np.sort(pos[starts[qi]:starts[qi + 1]]),
            oracle.search_all(text, q[qi]),
        )


def test_bfs_empty_ranges(bounded):
    sa_intv, _, arrays = bounded
    z = torch.tensor([5, 0, 77], dtype=torch.int64)
    got = tfm.bfs_locate_device(arrays, z, z.clone(), sa_intv)
    assert got.shape == (0,) and got.dtype == torch.int64
    assert tfm.batch_bfs_stats_device(arrays, z, z.clone(), sa_intv) == (0, 0)
    none = torch.empty(0, dtype=torch.int64)
    assert tfm.batch_bfs_stats_device(arrays, none, none, sa_intv) == (0, 0)
    with pytest.raises(ValueError, match="shape"):
        tfm.bfs_locate_device(arrays, z, z[:2], sa_intv)


@pytest.mark.parametrize("sa_intv", [2, 4])
def test_bfs_equals_walk_on_full_sa_index(text, sa_intv):
    """On a fully sorted index both locate paths give the same sets, the
    same count and the same checksum; the whole-table range [0, N) too."""
    t = tfm.FMIndex(sa_intv=sa_intv, device="cpu").build(text)
    assert t.full_sa
    q = _queries(text, QLEN, 6)
    beg, end, _ = t._ranges(q)
    assert tfm.batch_bfs_stats_device(t.arrays, beg, end, sa_intv) == (
        tfm.batch_locate_stats_device(t.arrays, beg, end, sa_intv,
                                      blocks=t.blocks)
    )
    N = len(text) + 1
    whole = tfm.bfs_locate_device(
        t.arrays, torch.tensor([0]), torch.tensor([N]), sa_intv
    )
    np.testing.assert_array_equal(np.sort(whole.numpy()), np.arange(N))
    walk = t.locate_rows(np.arange(N))
    np.testing.assert_array_equal(np.sort(walk), np.arange(N))


def test_fmindex_routes_bounded_build_through_bfs(text):
    """``FMIndex.build(sort_len=32)`` in the port: not full_sa, and
    get_offsets / batch_query / batch_query_stats answer like kiss_tpu's
    bounded index and like the oracle."""
    j = jfm.FMIndex(sa_intv=4).build(text, sort_len=32)
    t = tfm.FMIndex(sa_intv=4, device="cpu").build(text, sort_len=32)
    assert not t.full_sa and t._routes_to_bfs()
    q = _queries(text, QLEN, 7)
    assert t.batch_query_stats(q) == j.batch_query_stats(q)
    tl, tp, ts = t.batch_query(q)
    jl, jp, js = j.batch_query(q)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)  # same order: same BFS
    assert tp.dtype == np.uint32
    beg, end, _ = t.get_range(q[1])
    np.testing.assert_array_equal(
        np.sort(t.get_offsets(beg, end)), oracle.search_all(text, q[1])
    )
    np.testing.assert_array_equal(np.sort(t.fmtree(q[1])),
                                  np.sort(j.fmtree(q[1])))
    assert t.get_offsets(3, 3).shape == (0,)
    assert t.batch_query_stats(np.empty((0, QLEN), np.int8)) == (0, 0)


@pytest.mark.parametrize("name", ["genome20k", "random4k", "repeat3k"])
def test_load_reference_fmi_and_query(name):
    """The ``.fmi`` written by the compiled reference binary (32-ordered,
    no sidecar) loads through the port and answers the stored pattern
    batch with the reference's own occ/checksum -- the port's form of
    tests/test_golden.py::test_load_reference_fmi_and_query."""
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    fmi = tfm.FMIndex(sa_intv=4, device="cpu").load(
        io.BytesIO(data["fmi"].tobytes())
    )
    assert fmi.n_rows == len(data["text"]) + 1 and not fmi.full_sa
    raw = data["patterns"].tobytes()
    qlen, nq = struct.unpack("<II", raw[:8])
    queries = np.frombuffer(raw[8:], dtype=np.int8).reshape(nq, qlen)
    assert fmi.batch_query_stats(queries) == tuple(
        int(x) for x in data["query_stats"]
    )
    text = data["text"]
    q = text[100:111]
    beg, end, offs = fmi.get_range(q)
    hits = oracle.search_all(text, q)
    assert offs == 0 and end - beg == len(hits)
    np.testing.assert_array_equal(np.sort(fmi.get_offsets(beg, end)),
                                  np.sort(hits))


def _oracle_stats(text, queries):
    hits = [oracle.search_all(text, q) for q in queries]
    return sum(len(h) for h in hits), sum(int(h.sum()) for h in hits)


def _edge_queries(text):
    """Every one-symbol query (their ranges reach row N) and 5-mers from
    the start, middle and end of the text."""
    n = len(text)
    fives = np.stack([text[s : s + 5] for s in (0, n // 2, n - 5)])
    return np.arange(4, dtype=np.int8)[:, None], fives


@pytest.mark.parametrize("sa_intv", [2, 4, 8])
@pytest.mark.parametrize("n", [63, 127, 1023])
def test_bfs_at_n_plus_one_multiple_of_64(n, sa_intv):
    """N = n + 1 a multiple of 64: a range endpoint at row N has no b_tab
    row (b_tab keeps kiss_tpu's ceil(N / 64) rows); its mark rank is the
    count of all marks. Positions and stats of a 32-ordered build, and
    of its archive loaded without a ``.meta``, equal the brute-force
    oracle's (kiss_tpu clamps that gather and answers wrongly here)."""
    text = oracle.random_dna(n, seed=n)
    built = tfm.FMIndex(sa_intv=sa_intv, device="cpu").build(text,
                                                            sort_len=32)
    assert built.arrays.b_tab.shape[0] == (n + 1) // 64
    buf = io.BytesIO()
    built.save(buf)
    loaded = tfm.FMIndex(sa_intv=sa_intv, device="cpu").load(
        io.BytesIO(buf.getvalue())
    )
    for fmi in (built, loaded):
        assert fmi._routes_to_bfs()
        for q in _edge_queries(text):
            assert fmi.batch_query_stats(q) == _oracle_stats(text, q)
            lens, pos, _ = fmi.batch_query(q)
            starts = np.concatenate([[0], np.cumsum(lens)])
            for qi in range(len(q)):
                np.testing.assert_array_equal(
                    np.sort(pos[starts[qi] : starts[qi + 1]]),
                    oracle.search_all(text, q[qi]),
                )


def test_cli_bfs_at_n_plus_one_multiple_of_64(tmp_path, caplog):
    """The CLI pair: ``fmindex_build -k 32`` of a 127-character genome,
    then ``fmindex_query -b`` and ``-q`` through the range BFS."""
    import logging

    from kiss_tpu_torch import cli as tcli
    from kiss_tpu_torch.utils import codec, fasta

    text = oracle.random_dna(127, seed=127)
    fa = str(tmp_path / "g.fa")
    fasta.write_fasta(fa, [fasta.FastaRecord("g", text)])
    rng = np.random.default_rng(3)
    pats = [text[s : s + 25] for s in rng.integers(0, 127 - 25, 3)]
    bpath = str(tmp_path / "p.bin")
    with open(bpath, "wb") as f:
        f.write(struct.pack("<II", 25, len(pats)))
        f.write("".join(codec.to_string(p) for p in pats).encode())
    cpu = ["--device", "cpu", fa]
    assert tcli.main(["fmindex_build", "-k", "32", *cpu]) == 0
    with caplog.at_level(logging.INFO, logger="kiss_tpu_torch"):
        assert tcli.main(["fmindex_query", "-b", bpath, *cpu]) == 0
        assert tcli.main(["fmindex_query", "-q", "T", "-n", "0", *cpu]) == 0
    msgs = [r.getMessage() for r in caplog.records]
    occ, checksum = _oracle_stats(text, pats)
    assert f"number of matched locations: {occ}" in msgs
    assert f"location checksum: {checksum}" in msgs
    t_hits = len(oracle.search_all(text, np.array([3], np.int8)))
    assert f"query = T found {t_hits} times" in msgs

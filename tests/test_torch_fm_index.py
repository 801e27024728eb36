"""kiss_tpu_torch.models.fm_index against kiss_tpu on the same numpy
inputs: every FMArrays field, the .fmi bytes, and the query path (K2 and
K3's plain versions) run on the index JAX built, carried across with
``arrays_from_numpy``. Every comparison is exact (integers)."""

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


def _np_arrays(fmi):
    return {k: np.asarray(v) for k, v in fmi.arrays._asdict().items()}


@pytest.fixture(scope="module")
def pair():
    """(text, {lookup_len: (jax FMIndex, port FMIndex)}) on a
    repeat-heavy text (deep ties exercise the tail refinement)."""
    text = oracle.repeat_heavy_dna(12_000, unit=700, seed=5)
    built = {}
    for L in (0, 4):
        j = jfm.FMIndex(sa_intv=4, lookup_len=L).build(text)
        t = tfm.FMIndex(sa_intv=4, lookup_len=L, device="cpu").build(text)
        built[L] = (j, t)
    return text, built


def _queries(text, qlen, seed):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - qlen, 60)
    q = text[starts[:, None] + np.arange(qlen)[None, :]]
    q[::4] = rng.integers(0, 4, (15, qlen))
    return np.ascontiguousarray(q, dtype=np.int8)


@pytest.mark.parametrize("lookup_len", [0, 4])
def test_fmarrays_fields_equal(pair, lookup_len):
    _, built = pair
    j, t = built[lookup_len]
    want = _np_arrays(j)
    for name in tfm.FMArrays._fields:
        got = getattr(t.arrays, name).numpy()
        if name in tfm._BIT_FIELDS:
            assert got.dtype == np.int32, name
            got = got.view(np.uint32)
        np.testing.assert_array_equal(
            got.astype(np.int64), want[name].astype(np.int64), err_msg=name
        )
        assert got.shape == want[name].shape, name


@pytest.mark.parametrize("lookup_len", [0, 4])
def test_fmi_bytes_equal(pair, lookup_len):
    _, built = pair
    j, t = built[lookup_len]
    bj, bt = io.BytesIO(), io.BytesIO()
    j.save(bj)
    t.save(bt)
    assert bt.getvalue() == bj.getvalue()
    # and the port reads its own archive back to the same arrays
    loaded = tfm.FMIndex(sa_intv=4, device="cpu").load(
        io.BytesIO(bt.getvalue())
    )
    assert loaded == t and loaded.lookup_len == lookup_len


def test_fmi_bytes_equal_golden_random4k():
    data = np.load(os.path.join(GOLDEN, "random4k.npz"))
    t = tfm.FMIndex(sa_intv=4, device="cpu").build(data["text"])
    buf = io.BytesIO()
    t.save(buf)
    assert buf.getvalue() == data["fmi"].tobytes()


@pytest.mark.parametrize("qlen", [1, 12, 16, 17, 25])
@pytest.mark.parametrize("lookup_len", [0, 4])
def test_ranges_on_jax_index_equal(pair, qlen, lookup_len):
    """K2's plain version on the index JAX built == get_range_packed_device."""
    text, built = pair
    j, _ = built[lookup_len]
    arrays = tfm.arrays_from_numpy(_np_arrays(j), "cpu")
    blocks = tfm.block_table(arrays, 4)
    q = _queries(text, qlen, qlen)
    qw = jpack.np_pack_queries_2bit(q)
    for early in (True, False):
        want = jfm.get_range_packed_device(
            j.arrays, jnp.asarray(qw), qlen, lookup_len, early
        )
        got = tfm.get_range_packed_device(
            arrays, torch.from_numpy(qw.view(np.int32)), qlen, lookup_len,
            early, blocks=blocks,
        )
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the unpacked entry point packs on the host: same answer
    got2 = tfm.get_range_device(arrays, q, lookup_len, blocks=blocks)
    want2 = jfm.get_range_device(j.arrays, jnp.asarray(q), lookup_len)
    for w, g in zip(want2, got2):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_locate_rows_and_stats_on_jax_index_equal(pair):
    text, built = pair
    j, _ = built[0]
    arrays = tfm.arrays_from_numpy(_np_arrays(j), "cpu")
    rows = np.random.default_rng(3).integers(0, len(text) + 1, 2048)
    want = jfm.locate_rows_device(j.arrays, jnp.asarray(rows, jnp.int32), 4)
    blocks = tfm.block_table(arrays, 4)
    got = tfm.locate_rows_device(arrays, torch.from_numpy(rows), 4,
                                 blocks=blocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    q = _queries(text, 9, 1)
    qw = jpack.np_pack_queries_2bit(q)
    jb, je, _ = jfm.get_range_packed_device(j.arrays, jnp.asarray(qw), 9, 0)
    total = int(jnp.sum(je - jb))
    lo, hi = jfm.batch_locate_stats_device(
        j.arrays, jb, je, 4, jfm._pow2_cap(total, 128)
    )
    want_chk = int(np.asarray(lo, np.int64).sum()) + (
        int(np.asarray(hi, np.int64).sum()) << 16
    )
    tb = torch.from_numpy(np.asarray(jb).astype(np.int64))
    te = torch.from_numpy(np.asarray(je).astype(np.int64))
    assert tfm.batch_locate_stats_device(arrays, tb, te, 4,
                                         blocks=blocks) == (
        total, want_chk
    )


def test_port_build_queries_equal_jax(pair):
    """The port's own index answers like JAX's, end to end."""
    text, built = pair
    for L in (0, 4):
        j, t = built[L]
        q = _queries(text, 14, 40 + L)
        for a, b in zip(j.get_ranges(q), t.get_ranges(q)):
            np.testing.assert_array_equal(b, np.asarray(a).astype(np.int64))
        assert t.batch_query_stats(q) == j.batch_query_stats(q)
        np.testing.assert_array_equal(t.counts(q), j.counts(q))
        lens, pos, starts = t.batch_query(q)
        for qi in range(len(q)):
            hits = oracle.search_all(text, q[qi])
            assert lens[qi] == len(hits)
            np.testing.assert_array_equal(
                np.sort(pos[starts[qi]:starts[qi + 1]]), hits
            )
        np.testing.assert_array_equal(
            np.sort(t.fmtree(q[1])), np.sort(j.fmtree(q[1]))
        )


def test_lookup_table_monotone_and_seeded_search():
    text = oracle.random_dna(500, seed=11)
    t = tfm.FMIndex(sa_intv=4, lookup_len=6, device="cpu").build(text)
    lut = t.arrays.lookup.numpy()
    assert lut.shape[0] == 4**6 + 1 and (np.diff(lut) >= 0).all()
    np.testing.assert_array_equal(
        lut,
        np.asarray(jfm.FMIndex(sa_intv=4, lookup_len=6).build(text)
                   .arrays.lookup),
    )
    # seeded and unseeded searches count alike (an absent pattern's empty
    # range may sit elsewhere: the two stop at different steps)
    plain = tfm.FMIndex(sa_intv=4, lookup_len=0, device="cpu").build(text)
    q = _queries(text, 9, 2)
    sb, se, _ = t.get_ranges(q)
    pb, pe, _ = plain.get_ranges(q)
    np.testing.assert_array_equal(se - sb, pe - pb)
    hit = se > sb
    np.testing.assert_array_equal(sb[hit], pb[hit])


def test_sa_intv_1():
    text = oracle.random_dna(3_000, seed=3)
    t = tfm.FMIndex(sa_intv=1, device="cpu").build(text)
    q = text[100:112]
    beg, end, _ = t.get_range(q)
    np.testing.assert_array_equal(
        np.sort(t.get_offsets(beg, end)), oracle.search_all(text, q)
    )


@pytest.mark.parametrize("name", ["genome20k", "random4k", "repeat3k"])
def test_golden_query_stats(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    raw = data["patterns"].tobytes()
    qlen, nq = struct.unpack("<II", raw[:8])
    queries = np.frombuffer(raw[8:], dtype=np.int8).reshape(nq, qlen)
    t = tfm.FMIndex(sa_intv=4, device="cpu").build(data["text"])
    assert t.batch_query_stats(queries) == tuple(
        int(x) for x in data["query_stats"]
    )


def test_bfs_routes_raise():
    """Locate on an index not known to come from a full sort goes through
    the range BFS and answers (it raised before the BFS was ported); bad
    ranges handed to the BFS entry points still raise."""
    data = np.load(os.path.join(GOLDEN, "repeat3k.npz"))
    text = data["text"]
    loaded = tfm.FMIndex(sa_intv=4, device="cpu").load(
        io.BytesIO(data["fmi"].tobytes())
    )
    assert not loaded.full_sa and loaded._routes_to_bfs()
    q = text[100:111]
    hits = oracle.search_all(text, q)
    beg, end, _ = loaded.get_range(q)
    assert end - beg == len(hits)
    np.testing.assert_array_equal(np.sort(loaded.get_offsets(beg, end)), hits)
    assert loaded.batch_query_stats(q[None, :]) == (len(hits), int(hits.sum()))
    bounded = tfm.FMIndex(sa_intv=4, device="cpu").build(text, sort_len=32)
    assert not bounded.full_sa
    lens, pos, starts = bounded.batch_query(q[None, :])
    assert lens.tolist() == [len(hits)] and starts.tolist() == [0, len(hits)]
    np.testing.assert_array_equal(np.sort(pos), hits)
    # a fully sorted build keeps the per-row walk
    full = tfm.FMIndex(sa_intv=4, device="cpu").build(text)
    assert full.full_sa and not full._routes_to_bfs()
    with pytest.raises(TypeError, match="beg"):
        tfm.bfs_locate_device(loaded.arrays,
                              torch.tensor([0], dtype=torch.int32),
                              torch.tensor([1]), 4)
    with pytest.raises(ValueError, match="shape"):
        tfm.batch_bfs_stats_device(loaded.arrays, torch.tensor([0, 1]),
                                   torch.tensor([1]), 4)

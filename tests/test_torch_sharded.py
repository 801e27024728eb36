"""The port's sharded index on CPU shards against ``kiss_tpu``'s on its
virtual mesh: the sharded build (``build_index_sharded`` +
``trim_canonical``: every array and the ``.fmi`` bytes), the row-sharded
queries (``ShardedFMQuery``: ranges, offsets and batch stats on full-sort
and 32-ordered archives, with and without a lookup table), the
data-parallel ``sharded_batch_query`` and ``sharded_pipeline_step``.
Every comparison is exact."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiss_tpu.models import fm_index as jfm
from kiss_tpu.parallel import fm_build as jfm_build
from kiss_tpu.parallel import fm_sharded as jfm_sharded
from kiss_tpu.parallel import mesh as jmesh
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.parallel import (
    fm_build,
    fm_sharded,
    make_mesh,
    sharded_batch_query,
    sharded_pipeline_step,
)
from tests import oracle

torch.set_num_threads(1)


def _fmi_bytes(mod, arrays, N, sa_intv, **kw):
    idx = mod.FMIndex(sa_intv=sa_intv, lookup_len=0, arrays=arrays,
                      n_rows=N, **kw)
    buf = io.BytesIO()
    idx.save(buf)
    return buf.getvalue()


# N = n + 1 a multiple of 64 for the first three (b_tab has ceil(N / 64)
# rows there), then a text that spans several 256-row blocks per shard
@pytest.mark.parametrize("n,D", [(63, 3), (127, 4), (1023, 4), (5000, 3)])
@pytest.mark.parametrize("sa_intv", [1, 4])
def test_sharded_build_equals_kiss_tpu(n, D, sa_intv):
    text = oracle.repeat_heavy_dna(n, unit=29, seed=n) if n > 1000 \
        else oracle.random_dna(n, seed=n)
    N = n + 1
    sa = k_ordered_suffix_array(text, -1, as_numpy=False, device="cpu")
    jsa = jnp.asarray(sa.numpy().astype(np.uint32))
    want = jfm_build.trim_canonical(
        jfm_build.build_index_sharded(jmesh.make_mesh(D), jnp.asarray(text),
                                      jsa, sa_intv, force_u32=True),
        N, sa_intv)
    got = fm_build.trim_canonical(
        fm_build.build_index_sharded(make_mesh(D, device="cpu"), text, sa,
                                     sa_intv),
        N, sa_intv)
    single = fm.build_index_device(torch.from_numpy(text), sa, sa_intv)
    for name in fm.FMArrays._fields:
        g = getattr(got, name)
        assert g.dtype == getattr(single, name).dtype, name
        assert torch.equal(g, getattr(single, name)), name
        w = np.asarray(getattr(want, name))
        if name in fm._BIT_FIELDS:
            w = w.astype(np.uint32).view(np.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.b_tab.shape[0] == (-(-N // 64) if sa_intv != 1 else 1)
    assert (_fmi_bytes(fm, got, N, sa_intv, device="cpu")
            == _fmi_bytes(jfm, want, N, sa_intv))


@pytest.fixture(scope="module", params=["full", "k32"])
def archives(request, tmp_path_factory):
    """The same repeat-heavy text indexed by both packages, their
    ``.fmi`` bytes equal (full sort: the per-row walk; 32-ordered: the
    range BFS), with lookup tables of 0 and 5."""
    text = oracle.repeat_heavy_dna(7000, unit=300, seed=31)
    sort_len = None if request.param == "full" else 32
    out = {}
    for lookup in (0, 5):
        jf = jfm.FMIndex(sa_intv=4, lookup_len=lookup).build(
            text, sort_len=sort_len)
        tf = fm.FMIndex(sa_intv=4, lookup_len=lookup, device="cpu").build(
            text, sort_len=sort_len)
        buf = io.BytesIO()
        tf.save(buf)
        assert buf.getvalue() == _save_jax(jf)
        tf.full_sa = jf.full_sa = request.param == "full"
        out[lookup] = (jf, tf)
    rng = np.random.default_rng(4)
    queries = np.stack(
        [text[p : p + 14] for p in rng.integers(0, len(text) - 14, 40)]
        + [rng.integers(0, 4, 14).astype(np.int8) for _ in range(8)])
    return text, out, queries


def _save_jax(jf):
    buf = io.BytesIO()
    jf.save(buf)
    return buf.getvalue()


@pytest.mark.parametrize("lookup", [0, 5])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_query_equals_kiss_tpu(archives, lookup, D):
    text, idx, queries = archives
    jf, tf = idx[lookup]
    jq = jfm_sharded.ShardedFMQuery(jmesh.make_mesh(D), jf)
    tq = fm_sharded.ShardedFMQuery(make_mesh(D, device="cpu"), tf)
    got, want = tq.get_ranges(queries), jq.get_ranges(queries)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tq.batch_query_stats(queries) == jq.batch_query_stats(queries)
    assert tq.batch_query_stats(queries) == tf.batch_query_stats(queries)
    for qi in (0, 7, 41):
        beg, end, offs = tq.get_range(queries[qi])
        assert (beg, end, offs) == jq.get_range(queries[qi])
        pos = tq.get_offsets(beg, end)
        np.testing.assert_array_equal(pos, jq.get_offsets(beg, end))
        np.testing.assert_array_equal(
            np.sort(pos), oracle.search_all(text, queries[qi]))


def test_sharded_stats_download_no_positions(archives, monkeypatch):
    """``batch_query_stats`` on the mesh downloads two integers, not every
    position: on the 32-ordered archive it takes the range BFS's stats
    (kernel K4 on a card) on the lead device's tables. They equal
    kiss_tpu's on its virtual mesh."""
    _, idx, queries = archives
    jf, tf = idx[0]
    jq = jfm_sharded.ShardedFMQuery(jmesh.make_mesh(4), jf)
    tq = fm_sharded.ShardedFMQuery(make_mesh(4, device="cpu"), tf)

    def positions(*args, **kwargs):
        raise AssertionError("the positions went to the host")

    monkeypatch.setattr(fm.FMIndex, "_bfs_positions", positions)
    assert tq.batch_query_stats(queries) == jq.batch_query_stats(queries)


def test_sharded_locate_every_row():
    """The row-sharded walk at every row of a full-sort index (sa_intv 4)
    and at sa_intv 1 against the single-device walk, on 3 shards."""
    text = oracle.random_dna(3000, seed=9)
    for sa_intv in (1, 4):
        tf = fm.FMIndex(sa_intv=sa_intv, device="cpu").build(text)
        arrays = fm_sharded.shard_fm_arrays(make_mesh(3, device="cpu"),
                                            tf.arrays)
        rows = torch.arange(len(text) + 1)
        got = fm_sharded.sharded_locate_rows(make_mesh(3, device="cpu"),
                                             arrays, rows, sa_intv)
        want = fm.locate_rows_device_plain(tf.arrays, rows, sa_intv)
        assert torch.equal(got, want)


def test_sharded_batch_query_and_pipeline_step():
    """Data-parallel K2 (its plain version on CPU shards) against
    kiss_tpu's on the same mesh sizes, and over a query count that does
    not divide the mesh (which kiss_tpu's sharding rejects) against the
    single-device search; then the pipeline step."""
    text = oracle.random_dna(4096, seed=5)
    rng = np.random.default_rng(0)
    queries = rng.integers(0, 4, (20, 9)).astype(np.int8)
    jf = jfm.FMIndex(sa_intv=4).build(text)
    tf = fm.FMIndex(sa_intv=4, device="cpu").build(text)
    for D in (2, 4):
        want = jmesh.sharded_batch_query(jmesh.make_mesh(D), jf.arrays,
                                         jnp.asarray(queries))
        got = sharded_batch_query(make_mesh(D, device="cpu"), tf.arrays,
                                  queries, blocks=tf.blocks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        got = sharded_batch_query(make_mesh(D + 1, device="cpu"), tf.arrays,
                                  queries[:19], blocks=tf.blocks)
        for g, w in zip(got, tf.get_ranges(queries[:19])):
            np.testing.assert_array_equal(g.numpy(), w)
    small = oracle.random_dna(1024, seed=6)
    qs = rng.integers(0, 4, (16, 8)).astype(np.int8)
    want = jmesh.sharded_pipeline_step(jmesh.make_mesh(4),
                                       jnp.asarray(small), jnp.asarray(qs))
    got = sharded_pipeline_step(make_mesh(4, device="cpu"), small, qs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [int(c) for c in got[2]] == [
        len(oracle.search_all(small, q)) for q in qs]

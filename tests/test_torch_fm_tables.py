"""The block table of the query kernels (``kiss_tpu_torch.models.fm_index.
block_table``), read back on the CPU with small numpy readers and held,
at every row, against the counts the index's own tables give: the port's
``_occ``, ``_bwt_at``, ``_b_at``, ``_b_rank`` and kiss_tpu's ``_occ``,
``_b_rank``, ``_b_at``, on indexes JAX built. Every comparison is exact.

Sizes: N = n + 1 rows for n in {1, 63, 64, 65, 1000} (a partial block;
one whole block and an entry for row N alone, which b_tab has no row for;
two blocks; sixteen) and n = 70,000 (two superblocks of 65,536 rows), each
at sa_intv 1, 2 and 4; at n = 1000 and 70,000 the sentinel row lies in
the first, a middle or the last block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiss_tpu.models import fm_index as jfm
from kiss_tpu_torch.models import fm_index as tfm

torch.set_num_threads(1)

# where the sentinel row (the whole text's suffix) sorts: a long run of the
# smallest symbol in front puts it in the first block, of the largest in
# the last; a random text puts it in the middle
SENTINEL_PREFIX = {"first": 0, "last": 3, "middle": None}


def _text(n, where, seed):
    text = np.random.default_rng(seed).integers(0, 4, n).astype(np.int8)
    if SENTINEL_PREFIX[where] is not None:
        text[:24] = SENTINEL_PREFIX[where]
    return text


_CACHE = {}


def _index(n, sa_intv, where):
    """(jax FMIndex, port FMArrays of it, its FMBlocks as numpy) -- cached:
    each index serves the tests of both comparison targets."""
    key = (n, sa_intv, where)
    if key not in _CACHE:
        text = _text(n, where, seed=n + 7 * sa_intv)
        j = jfm.FMIndex(sa_intv=sa_intv, lookup_len=0).build(text)
        arrays = tfm.arrays_from_numpy(
            {k: np.asarray(v) for k, v in j.arrays._asdict().items()}, "cpu"
        )
        blocks = tfm.block_table(arrays, sa_intv)
        _CACHE[key] = (j, arrays, blocks)
    return _CACHE[key]


CASES = (
    [(n, s, "middle") for n in (1, 63, 64, 65) for s in (1, 2, 4)]
    + [(n, s, w) for n in (1000, 70_000) for s in (1, 2, 4)
       for w in ("first", "middle", "last")]
)


# ------------------------------------------------- readers of the table


class Reader:
    """Plain numpy readers of an FMBlocks, as the kernels read it."""

    def __init__(self, blocks, arrays):
        self.blk = blocks.blk.numpy().view(np.uint32).astype(np.int64)
        self.sup = blocks.sup.numpy()
        self.cnt = arrays.cnt.numpy()
        self.pri = int(arrays.pri)
        lanes = np.arange(16, dtype=np.int64)
        # the 64 dibits of every entry, row order
        self.dibits = ((self.blk[:, :4, None] >> (2 * lanes)) & 3).reshape(
            -1, 64
        )
        self.marks = self.blk[:, 4] | (self.blk[:, 5] << 32)

    def occ(self, c, i):
        """Rows r < i with bwt[r] == c (the sentinel row counts as none)."""
        return self.lf(c, i) - self.cnt[c]

    def lf(self, c, i):
        """LF(c, i) = cnt[c] + occ(c, i), as the kernels step."""
        e = self.blk[i >> 6]
        b0, s0 = i & ~63, i & ~65535
        r0, r1, r2 = e[:, 6] & 0xFFFF, e[:, 6] >> 16, e[:, 7] & 0xFFFF
        sentinel_before = (s0 <= self.pri) & (self.pri < b0)
        r3 = (b0 - s0) - r0 - r1 - r2 - sentinel_before
        rel = np.choose(c, [r0, r1, r2, r3])
        inside = (
            (self.dibits[i >> 6] == c[:, None])
            & (np.arange(64) < (i & 63)[:, None])
        ).sum(axis=1)
        inside -= (c == 0) & (b0 <= self.pri) & (self.pri < i)
        return self.sup[i >> 16, c] + rel + inside

    def bwt(self, i):
        return self.dibits[i >> 6, i & 63]

    def mark(self, i):
        return ((self.marks[i >> 6] >> (i & 63)) & 1) == 1

    def mark_rank(self, i):
        """Marked rows r < i."""
        below = self.marks[i >> 6] & ((1 << (i & 63)) - 1)
        bits = np.unpackbits(below.astype("<u8").view(np.uint8)).reshape(
            -1, 64
        ).sum(axis=1)
        return self.sup[i >> 16, 4] + (self.blk[i >> 6, 7] >> 16) + bits


def _rows(arrays):
    N = int(arrays.lookup[-1])
    return N, np.arange(N + 1, dtype=np.int64)  # occ and ranks at 0..N


@pytest.mark.parametrize("n,sa_intv,where", CASES)
def test_block_table_against_port_tables(n, sa_intv, where):
    _, arrays, blocks = _index(n, sa_intv, where)
    N, i = _rows(arrays)
    nblk = N // 64 + 1
    assert blocks.blk.shape == (nblk, 8) and blocks.blk.dtype == torch.int32
    assert blocks.sup.shape == ((nblk - 1) // 1024 + 1, 8)
    rd = Reader(blocks, arrays)
    ti = torch.from_numpy(i)
    for c in range(4):
        cc = np.full_like(i, c)
        want = tfm._occ(arrays, torch.from_numpy(cc), ti).numpy()
        np.testing.assert_array_equal(rd.occ(cc, i), want, err_msg=f"c={c}")
        want = tfm._lf(arrays, torch.from_numpy(cc), ti).numpy()
        np.testing.assert_array_equal(rd.lf(cc, i), want, err_msg=f"c={c}")
    rows = ti[:N]
    np.testing.assert_array_equal(
        rd.bwt(i[:N]), tfm._bwt_at(arrays, rows).numpy()
    )
    if sa_intv == 1:  # every row sampled: no marks, sa_samp read directly
        assert not rd.marks.any() and not rd.sup[:, 4].any()
        return
    np.testing.assert_array_equal(rd.mark(i[:N]),
                                  tfm._b_at(arrays, rows).numpy())
    np.testing.assert_array_equal(rd.mark_rank(i[:N]),
                                  tfm._b_rank(arrays, rows).numpy())
    # past the last row: every mark, whether or not b_tab has a row there
    assert rd.mark(i[:N]).sum() == arrays.sa_samp.shape[0]
    assert rd.mark_rank(i[N:]) == [arrays.sa_samp.shape[0]]


@pytest.mark.parametrize("n,sa_intv,where", CASES)
def test_block_table_against_jax(n, sa_intv, where):
    j, arrays, blocks = _index(n, sa_intv, where)
    N, i = _rows(arrays)
    rd = Reader(blocks, arrays)
    ji = jnp.asarray(i.astype(np.int32))
    for c in range(4):
        cc = np.full_like(i, c)
        want = np.asarray(jfm._occ(j.arrays, jnp.asarray(cc, jnp.int32), ji))
        np.testing.assert_array_equal(rd.occ(cc, i), want.astype(np.int64),
                                      err_msg=f"c={c}")
    if sa_intv != 1:
        np.testing.assert_array_equal(
            rd.mark(i[:N]), np.asarray(jfm._b_at(j.arrays, ji[:N]))
        )
        np.testing.assert_array_equal(
            rd.mark_rank(i[:N]),
            np.asarray(jfm._b_rank(j.arrays, ji[:N])).astype(np.int64),
        )


def test_sentinel_lands_where_asked():
    """The cases above do put the sentinel row in the block they name."""
    for where, want in (("first", 0), ("last", None)):
        _, arrays, _ = _index(70_000, 4, where)
        N = int(arrays.lookup[-1])
        blk = int(arrays.pri) // 64
        assert blk == (want if want is not None else (N - 1) // 64), where
    _, arrays, _ = _index(70_000, 4, "middle")
    assert 0 < int(arrays.pri) // 64 < (int(arrays.lookup[-1]) - 1) // 64


def test_block_table_of_port_build_and_load_equal():
    """FMIndex.build and FMIndex.load make the same table as block_table of
    the same arrays."""
    import io

    text = _text(3000, "middle", 3)
    built = tfm.FMIndex(sa_intv=4, device="cpu").build(text)
    buf = io.BytesIO()
    built.save(buf)
    loaded = tfm.FMIndex(sa_intv=4, device="cpu").load(
        io.BytesIO(buf.getvalue())
    )
    for fmi in (built, loaded):
        want = tfm.block_table(fmi.arrays, 4)
        assert torch.equal(fmi.blocks.blk, want.blk)
        assert torch.equal(fmi.blocks.sup, want.sup)


def test_block_table_rejects_a_foreign_b_tab():
    _, arrays, _ = _index(1000, 4, "middle")
    with pytest.raises(ValueError, match="b_tab"):
        tfm.block_table(arrays._replace(b_tab=arrays.b_tab[:3]), 4)

"""A CPU model of kernel K4's layout (``csrc/fm_bfs.cu``) against the range
BFS's plain version and kiss_tpu.

The model does what the kernel does, step by step, reading the block
table as the kernel reads it (``Reader`` of ``test_torch_fm_tables``): the
pruned depth-first walk of each query's tree with an explicit stack,
symbols 0..3 in order (pass 1 counts each (query, depth)'s non-empty
segments and rows; pass 2 writes each segment at its (query, depth) cursor,
its sa_samp start packed with its depth), the expansion of the output
slots by a search of the segment offsets (pass 3), and the stats entry
point's sums from ``samp_sum``. It must give ``bfs_locate_device_plain``'s
positions element for element and ``batch_bfs_stats_device_plain``'s
integers, on 32-ordered indexes with N % 64 == 0 and not, at sa_intv 2, 4
and 8, and on the archives the reference binary wrote. Every comparison is
exact (integers, tolerance 0).
"""

import io
import os
import struct

import numpy as np
import pytest
import torch

from kiss_tpu.models import fm_index as jfm
from kiss_tpu_torch.models import fm_index as tfm
from tests import oracle
from tests.test_torch_fm_tables import Reader

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
QLEN = 9  # 32 >= sa_intv - 1 + QLEN at sa_intv 8: the BFS is exact
DEPTH_SHIFT = 58  # a segment's sa_samp start | depth << 58, as the kernel


class Model:
    """K4 on the CPU: the kernel's three locate passes and its stats pass,
    over the block table of ``fmi``."""

    def __init__(self, fmi):
        self.rd = Reader(fmi.blocks, fmi.arrays)
        self.sa_intv = fmi.sa_intv
        self.sa_samp = fmi.arrays.sa_samp.numpy()
        self.samp_sum = fmi.blocks.samp_sum.numpy()
        self.deepest_stack = 0

    def walk(self, b0, e0):
        """(depth, mark_rank(b), mark_rank(e)) of every non-empty node of
        the tree of [b0, e0), in the kernel's depth-first preorder."""
        stack = [(b0, e0, 0)] if b0 < e0 else []
        sym = np.arange(4)
        while stack:
            self.deepest_stack = max(self.deepest_stack, len(stack))
            b, e, d = stack.pop()
            if e == b + 1:  # one row: one entry, one child by its symbol
                mb = int(self.rd.mark_rank(np.array([b]))[0])
                yield d, mb, mb + int(self.rd.mark(np.array([b]))[0])
                if d + 1 < self.sa_intv and b != self.rd.pri:
                    c = self.rd.bwt(np.array([b]))
                    cb = int(self.rd.lf(c, np.array([b]))[0])
                    stack.append((cb, cb + 1, d + 1))
                continue
            mb, me = (int(x) for x in self.rd.mark_rank(np.array([b, e])))
            yield d, mb, me
            if d + 1 < self.sa_intv:
                cb = self.rd.lf(sym, np.full(4, b))
                ce = self.rd.lf(sym, np.full(4, e))
                for c in (3, 2, 1, 0):  # symbol 0 pops first
                    if cb[c] < ce[c]:
                        stack.append((int(cb[c]), int(ce[c]), d + 1))

    def locate(self, beg, end):
        D = self.sa_intv
        q = len(beg)
        # pass 1: segments (row 0) and rows (row 1) of each (query,
        # depth), columns in order
        counts = np.zeros((2, q * D), dtype=np.int64)
        for i in range(q):
            for d, mb, me in self.walk(int(beg[i]), int(end[i])):
                if me > mb:
                    counts[:, i * D + d] += (1, me - mb)
        incl = np.cumsum(counts, axis=1)
        nseg, total = (int(x) for x in incl[:, -1]) if q else (0, 0)
        # pass 2: each segment at its (query, depth) cursor
        seg_off = np.full(nseg, -1, dtype=np.int64)
        seg_start = np.full(nseg, -1, dtype=np.int64)
        for i in range(q):
            cols = slice(i * D, (i + 1) * D)
            cur = incl[:, cols] - counts[:, cols]
            for d, mb, me in self.walk(int(beg[i]), int(end[i])):
                if me > mb:
                    s = cur[0, d]
                    seg_off[s] = cur[1, d]
                    seg_start[s] = mb | (d << DEPTH_SHIFT)
                    cur[:, d] += (1, me - mb)
        assert (seg_off >= 0).all() and (np.diff(seg_off) > 0).all()
        # pass 3: slot r belongs to the last segment whose offset <= r
        r = np.arange(total, dtype=np.int64)
        s = np.searchsorted(seg_off, r, side="right") - 1
        start = seg_start[s] & ((1 << DEPTH_SHIFT) - 1)
        return self.sa_samp[start + r - seg_off[s]] + (
            seg_start[s] >> DEPTH_SHIFT)

    def stats(self, beg, end):
        total = checksum = 0
        for b0, e0 in zip(beg, end):
            for d, mb, me in self.walk(int(b0), int(e0)):
                if me > mb:
                    total += me - mb
                    checksum += (int(self.samp_sum[me])
                                 - int(self.samp_sum[mb]) + d * (me - mb))
        checksum = (checksum + 2**63) % 2**64 - 2**63  # int64, as the card
        return total, checksum


def _ranges(fmi, text, seed, nq=24):
    """beg, end int64 of: sampled 9-mers (some altered: mostly absent),
    the four one-symbol queries (T's range ends at row N), an empty range
    and the whole table [0, N)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - QLEN, nq)
    q = text[starts[:, None] + np.arange(QLEN)[None, :]]
    q[::4] = rng.integers(0, 4, (len(q[::4]), QLEN))
    b9, e9, _ = fmi.get_ranges(np.ascontiguousarray(q, dtype=np.int8))
    b1, e1, _ = fmi.get_ranges(np.arange(4, dtype=np.int8)[:, None])
    N = fmi.n_rows
    beg = np.concatenate([b9, b1, [5, 0]]).astype(np.int64)
    end = np.concatenate([e9, e1, [5, N]]).astype(np.int64)
    return torch.from_numpy(beg), torch.from_numpy(end)


def _check_model(fmi, beg, end):
    """The model's positions and stats equal the plain version's, and its
    stack never holds more than 3 (sa_intv - 1) + 1 nodes."""
    m = Model(fmi)
    want = tfm.bfs_locate_device_plain(fmi.arrays, beg, end, fmi.sa_intv)
    np.testing.assert_array_equal(m.locate(beg.numpy(), end.numpy()),
                                  want.numpy())
    assert m.stats(beg.numpy(), end.numpy()) == (
        tfm.batch_bfs_stats_device_plain(fmi.arrays, beg, end, fmi.sa_intv))
    assert 0 < m.deepest_stack <= 3 * (fmi.sa_intv - 1) + 1
    return want


@pytest.mark.parametrize("sa_intv", [2, 4, 8])
@pytest.mark.parametrize("n", [63, 127, 1023, 3000])
def test_model_equals_the_plain_bfs(n, sa_intv):
    """32-ordered builds of random texts whose N = n + 1 is a multiple of
    64 (a range endpoint at row N has no b_tab row) and of a repeat-heavy
    text (long ties left in another order than the full sort's)."""
    text = (oracle.repeat_heavy_dna(n, unit=40, seed=8) if n == 3000
            else oracle.random_dna(n, seed=n))
    fmi = tfm.FMIndex(sa_intv=sa_intv, device="cpu").build(text,
                                                          sort_len=32)
    assert fmi._routes_to_bfs()
    beg, end = _ranges(fmi, text, seed=n + sa_intv)
    pos = _check_model(fmi, beg, end)
    # the whole table's range gives every position once
    np.testing.assert_array_equal(np.sort(pos[-fmi.n_rows:].numpy()),
                                  np.arange(fmi.n_rows))


@pytest.mark.parametrize("name", ["genome20k", "random4k", "repeat3k"])
def test_model_on_reference_written_archives(name):
    """The archives the reference binary wrote (32-ordered, sa_intv 4),
    loaded by both packages: the model equals the plain version, which
    equals kiss_tpu's BFS element for element on the stored batch."""
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    raw = data["fmi"].tobytes()
    fmi = tfm.FMIndex(sa_intv=4, device="cpu").load(io.BytesIO(raw))
    jf = jfm.FMIndex(sa_intv=4).load(io.BytesIO(raw))
    pat = data["patterns"].tobytes()
    qlen, nq = struct.unpack("<II", pat[:8])
    queries = np.frombuffer(pat[8:], dtype=np.int8).reshape(nq, qlen)
    beg, end, _ = fmi.get_ranges(queries)
    beg, end = torch.from_numpy(beg), torch.from_numpy(end)
    pos = _check_model(fmi, beg, end)
    np.testing.assert_array_equal(
        pos.numpy().astype(np.uint32),
        jf._bfs_positions(beg.numpy(), end.numpy()))


def test_model_without_queries():
    fmi = tfm.FMIndex(sa_intv=4, device="cpu").build(
        oracle.random_dna(500, seed=1), sort_len=32)
    none = torch.empty(0, dtype=torch.int64)
    m = Model(fmi)
    assert m.locate(none.numpy(), none.numpy()).shape == (0,)
    assert m.stats(none.numpy(), none.numpy()) == (0, 0)
    assert tfm.bfs_locate_device_plain(fmi.arrays, none, none, 4).shape == (0,)
    assert tfm.batch_bfs_stats_device(fmi.arrays, none, none, 4) == (0, 0)


def test_samp_sum_is_the_prefix_of_sa_samp():
    fmi = tfm.FMIndex(sa_intv=4, device="cpu").build(
        oracle.random_dna(700, seed=2))
    samp = fmi.arrays.sa_samp.numpy()
    np.testing.assert_array_equal(
        fmi.blocks.samp_sum.numpy(),
        np.concatenate([[0], np.cumsum(samp)]))


def test_wrappers_check_their_inputs_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions, with or without
    the block table; malformed ranges raise before either runs."""
    text = oracle.random_dna(500, seed=3)
    fmi = tfm.FMIndex(sa_intv=4, device="cpu").build(text, sort_len=32)
    beg, end = _ranges(fmi, text, seed=4, nq=6)
    want = tfm.bfs_locate_device_plain(fmi.arrays, beg, end, 4)
    for blocks in (None, fmi.blocks):
        assert torch.equal(
            tfm.bfs_locate_device(fmi.arrays, beg, end, 4, blocks=blocks),
            want)
        assert tfm.batch_bfs_stats_device(
            fmi.arrays, beg, end, 4, blocks=blocks) == (
            want.shape[0], int(want.sum()))
    with pytest.raises(TypeError, match="int64"):
        tfm.bfs_locate_device(fmi.arrays, beg.int(), end.int(), 4)
    with pytest.raises(ValueError, match="shape"):
        tfm.batch_bfs_stats_device(fmi.arrays, beg, end[:2], 4)

"""A CPU model of kernel K4's layout (``csrc/fm_bfs.cu``) against the range
BFS's plain version and kiss_tpu.

The model does what the kernel does, step by step, with the block table
read as the kernel reads it (``Reader`` of ``test_torch_fm_tables``), at a
tile, a warp and a frontier scaled down so that a few hundred rows give
several tiles and queries on the spill route:

- a warp's queries go to its part of the shared frontier, in query order,
  while their tree bounds (sum over depths of min(4^d, len)) are at most
  ``wide`` and sum to at most ``cap``; the others spill to the warp's share
  of a pool, whose total need the launch reports;
- each warp walks its trees level by level, its shared and its spilled
  nodes of a level in the same rounds of ``warp`` nodes; the children of a
  round are appended by an exclusive prefix of their counts, so a level
  stays in (query, column) order, and a visited node becomes its segment;
- stats: each segment's positions summed from ``samp_sum``;
- locate: the tile's query offsets by an exclusive scan, its global
  offsets by a look-back over windows of the statuses of the tiles before
  it (tiles run in waves, and look back in reverse order within a wave, so
  some find only aggregates), and each warp's segments written level by level
  at their places, bounded by the segment arrays' size; then the positions
  by a search of the segment offsets;
- the wrapper's loop (``fm_index.bfs_until_it_fits``) runs a launch again
  at the reported sizes until the outputs fit.

It must give ``bfs_locate_device_plain``'s positions element for element
and ``batch_bfs_stats_device_plain``'s integers, on 32-ordered indexes with
N % 64 == 0 and not, at sa_intv 2, 4 and 8, on the archives the reference
binary wrote, and outside the BFS contract; and kiss_tpu's positions where
the contract holds. Every comparison is exact (integers, tolerance 0).
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
ROW_MASK = (1 << 48) - 1  # a round's scan of rows | segment << 48


def tree_bound(n, depth):
    return sum(min(4**d, n) for d in range(depth))


class Model:
    """K4 on the CPU: its stats launch, its segment launch and the
    expansion, over the block table of ``fmi``. The kernel's sizes are
    tile 128, warp 32, cap 32 x the sa_intv bound (24 at the bound 32),
    wide 64, waves of the resident tiles, a look-back window of 32 tiles;
    the model's are small."""

    def __init__(self, fmi, tile=8, warp=4, cap=12, wide=16, wave=3,
                 window=2):
        self.rd = Reader(fmi.blocks, fmi.arrays)
        self.D = fmi.sa_intv
        self.tile, self.warp, self.cap = tile, warp, cap
        self.wide, self.wave, self.window = wide, wave, window
        self.sa_samp = fmi.arrays.sa_samp.numpy()
        self.samp_sum = fmi.blocks.samp_sum.numpy()
        self.launches = 0

    # -- one warp ---------------------------------------------------------

    def setup(self, beg, end, q0, qt0, pool_cap, report):
        """Level 0 of the warp whose queries start at q0 (the tile's qt0):
        the two stores (x, y, q arrays and level starts)."""
        q = np.arange(q0, min(q0 + self.warp, len(beg)))
        b, e = beg[q], end[q]
        lens = np.maximum(e - b, 0)
        tb = np.array([tree_bound(int(n), self.D) for n in lens],
                      dtype=np.int64)
        wide = tb > self.wide
        fill = np.cumsum(np.where(wide, 0, tb)) - np.where(wide, 0, tb)
        shared = (lens > 0) & ~wide & (fill + tb <= self.cap)
        spilled = (lens > 0) & ~shared
        need = int(tb[spilled].sum())
        ok = True
        if need:
            ok = report[3] + need <= pool_cap
            report[3] += need
            report[2] += int(spilled.sum())
        stores = []
        for flags, size in ((shared, self.cap), (spilled, need if ok else 0)):
            if not ok and flags is spilled:
                flags = np.zeros_like(flags)
            s = {"x": np.full(size, -1, np.int64),
                 "y": np.full(size, -1, np.int64),
                 "q": np.full(size, -1, np.int64)}
            n0 = int(flags.sum())
            s["x"][:n0], s["y"][:n0] = b[flags], e[flags]
            s["q"][:n0] = (q - q0 + qt0)[flags]
            s["lvl"] = [0, n0]
            stores.append(s)
        return stores

    def warps(self, beg, end, t0, pool_cap, report):
        """The stores of each warp of the tile starting at query t0."""
        return [self.setup(beg, end, q0, q0 - t0, pool_cap, report)
                for q0 in range(t0, min(t0 + self.tile, len(beg)),
                                self.warp)]

    def node(self, b, e, d):
        """(mark_rank(b), mark_rank(e), children [[(cb, ce), ...] a node])
        of a round's nodes, as the kernel reads them."""
        rd = self.rd
        one = e == b + 1
        mb = rd.mark_rank(b)
        me = np.where(one, mb + rd.mark(b), rd.mark_rank(e))
        kids = [[] for _ in b]
        if d + 1 < self.D:
            own = rd.lf(rd.bwt(b), b)  # a row's one child, by its symbol
            lfb = [rd.lf(np.full(len(b), c), b) for c in range(4)]
            lfe = [rd.lf(np.full(len(b), c), e) for c in range(4)]
            for k in range(len(b)):
                if one[k]:
                    if b[k] != rd.pri:
                        kids[k].append((own[k], own[k] + 1))
                else:
                    kids[k] = [(lfb[c][k], lfe[c][k]) for c in range(4)
                               if lfb[c][k] < lfe[c][k]]
        return mb, me, kids

    def walk(self, stores, visit):
        """The level-by-level walk of both stores: visit(store, j, d, mb,
        me) once a node; returns after the last level."""
        T = self.warp
        for d in range(self.D):
            spans = [(s["lvl"][d], s["lvl"][d + 1]) for s in stores]
            n0 = spans[0][1] - spans[0][0]
            total = n0 + spans[1][1] - spans[1][0]
            nxt = [spans[0][1], spans[1][1]]
            for r in range(0, total, T):
                idx = np.arange(r, min(r + T, total))
                g = (idx >= n0).astype(int)
                j = np.where(g == 1, spans[1][0] + idx - n0, spans[0][0] + idx)
                b = np.array([stores[gi]["x"][ji] for gi, ji in zip(g, j)])
                e = np.array([stores[gi]["y"][ji] for gi, ji in zip(g, j)])
                mb, me, kids = self.node(b, e, d)
                counts = np.array([len(k) for k in kids], dtype=np.int64)
                for k in range(len(idx)):
                    s = stores[g[k]]
                    visit(s, j[k], d, int(mb[k]), int(me[k]))
                for gi in (0, 1):
                    mine = np.where(g == gi, counts, 0)
                    pos = nxt[gi] + np.cumsum(mine) - mine  # ballot + prefix
                    s = stores[gi]
                    for k in np.flatnonzero(mine):
                        for c, (cb, ce) in enumerate(kids[k]):
                            s["x"][pos[k] + c] = cb  # past the store: raises
                            s["y"][pos[k] + c] = ce
                            s["q"][pos[k] + c] = s["q"][j[k]]
                    nxt[gi] += int(mine.sum())
            if d + 1 < self.D:
                for s, n in zip(stores, nxt):
                    s["lvl"].append(n)

    def tiles(self, nq):
        return range(0, nq, self.tile)

    # -- the launches ------------------------------------------------------

    def launch_stats(self, beg, end, pool_cap):
        """kt_fm_bfs_stats: (total, checksum, spilled, pool need)."""
        self.launches += 1
        report = [0, 0, 0, 0]

        def visit(s, j, d, mb, me):
            if me > mb:
                report[0] += me - mb
                report[1] += (int(self.samp_sum[me]) - int(self.samp_sum[mb])
                              + d * (me - mb))

        for t0 in self.tiles(len(beg)):
            for stores in self.warps(beg, end, t0, pool_cap, report):
                self.walk(stores, visit)
        report[1] = (report[1] + 2**63) % 2**64 - 2**63  # int64, as the card
        return report

    def launch_segments(self, beg, end, seg_cap, pool_cap):
        """kt_fm_bfs_segments: (seg_off, seg_start) int64 [seg_cap], -1
        where not written, and the report (segments, positions, spilled,
        pool need)."""
        self.launches += 1
        T = self.tile
        report = [0, 0, 0, 0]
        seg_off = np.full(seg_cap, -1, np.int64)
        seg_start = np.full(seg_cap, -1, np.int64)
        tiles = list(self.tiles(len(beg)))
        status = {}  # tile: [aggregate or None, inclusive or None]
        for w0 in range(0, len(tiles), self.wave):
            wave = range(w0, min(w0 + self.wave, len(tiles)))
            walked = {}
            for tile in wave:  # walk, then publish the aggregate
                warps = self.warps(beg, end, tiles[tile], pool_cap, report)
                per_q = np.zeros((2, T), np.int64)

                def visit(s, j, d, mb, me, per_q=per_q):
                    s["x"][j], s["y"][j] = mb, me - mb
                    if me > mb:
                        per_q[:, s["q"][j]] += (1, me - mb)

                for stores in warps:
                    self.walk(stores, visit)
                walked[tile] = (warps, per_q)
                status[tile] = [tuple(per_q.sum(axis=1)), None]
            for tile in reversed(wave):  # the look-back, latest first
                warps, per_q = walked[tile]
                segs = rows = 0
                # a window of the tiles before at once, nearest first; past
                # tile 0 an inclusive prefix of nothing
                for p in range(tile - 1, -self.window - 1, -self.window):
                    window = [status[x] if x >= 0 else [None, (0, 0)]
                              for x in range(p, p - self.window, -1)]
                    for agg, inc in window:
                        seen = inc if inc is not None else agg
                        segs, rows = segs + seen[0], rows + seen[1]
                        if inc is not None:
                            break
                    if any(inc is not None for _, inc in window):
                        break
                agg = status[tile][0]
                status[tile][1] = (segs + agg[0], rows + agg[1])
                if tile == len(tiles) - 1:
                    report[0], report[1] = status[tile][1]
                cur = np.cumsum(per_q, axis=1) - per_q  # query offsets
                for stores in warps:
                    self.write(stores, cur, (segs, rows), seg_off, seg_start)
        return seg_off, seg_start, report

    def write(self, stores, cur, base, seg_off, seg_start):
        """Each segment of a warp at its place, level by level; cur: the
        next segment and row of each of the tile's queries."""
        T = self.warp
        first = np.zeros_like(cur)
        for s in stores:
            for d in range(self.D):
                lb, le = s["lvl"][d], s["lvl"][d + 1]
                pend = np.zeros_like(cur)
                lvl = np.zeros(2, np.int64)  # segments, rows of the rounds
                for r in range(lb, le, T):
                    j = np.arange(r, min(r + T, le))
                    cnt, ql = s["y"][j], s["q"][j]
                    packed = cnt | (cnt > 0).astype(np.int64) << 48
                    at = np.cumsum(packed) - packed  # the warp's scan
                    sg, rw = lvl[0] + (at >> 48), lvl[1] + (at & ROW_MASK)
                    starts = (j == lb) | (s["q"][np.maximum(j - 1, lb)] != ql)
                    first[0, ql[starts]] = sg[starts]
                    first[1, ql[starts]] = rw[starts]
                    for k in np.flatnonzero(cnt > 0):
                        i = base[0] + cur[0, ql[k]] + sg[k] - first[0, ql[k]]
                        if i < len(seg_off):
                            seg_off[i] = (base[1] + cur[1, ql[k]] + rw[k]
                                          - first[1, ql[k]])
                            seg_start[i] = s["x"][j[k]] | d << DEPTH_SHIFT
                        pend[:, ql[k]] += (1, cnt[k])
                    lvl += (int((cnt > 0).sum()), int(cnt.sum()))
                cur += pend

    def expand(self, seg_off, seg_start, nseg, total):
        """kt_fm_bfs_expand: slot r belongs to the last segment whose
        offset <= r."""
        seg_off, seg_start = seg_off[:nseg], seg_start[:nseg]
        assert (seg_off >= 0).all() and (np.diff(seg_off) > 0).all()
        r = np.arange(total, dtype=np.int64)
        s = np.searchsorted(seg_off, r, side="right") - 1
        start = seg_start[s] & ((1 << DEPTH_SHIFT) - 1)
        return self.sa_samp[start + r - seg_off[s]] + (
            seg_start[s] >> DEPTH_SHIFT)

    # -- the wrappers ------------------------------------------------------

    def locate(self, beg, end, caps=None):
        beg, end = np.asarray(beg), np.asarray(end)
        if len(beg) == 0:
            return np.empty(0, np.int64)

        def run(seg_cap, pool_cap):
            seg_off, seg_start, rep = self.launch_segments(beg, end, seg_cap,
                                                           pool_cap)
            return (seg_off, seg_start, rep), rep[0], rep[3]

        seg_off, seg_start, rep = tfm.bfs_until_it_fits(
            run, *(caps or tfm.bfs_guess(len(beg))))
        self.spilled = rep[2]
        return self.expand(seg_off, seg_start, rep[0], rep[1])

    def stats(self, beg, end, caps=None):
        beg, end = np.asarray(beg), np.asarray(end)
        if len(beg) == 0:
            return 0, 0

        def run(_, pool_cap):
            rep = self.launch_stats(beg, end, pool_cap)
            return rep, 0, rep[3]

        rep = tfm.bfs_until_it_fits(run, 0, (caps or tfm.bfs_guess(
            len(beg)))[1])
        return rep[0], rep[1]


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


def _check_model(fmi, beg, end, caps=None):
    """The model's positions and stats equal the plain version's; the
    whole table's range took the spill route."""
    m = Model(fmi)
    want = tfm.bfs_locate_device_plain(fmi.arrays, beg, end, fmi.sa_intv)
    np.testing.assert_array_equal(m.locate(beg.numpy(), end.numpy(), caps),
                                  want.numpy())
    assert m.stats(beg.numpy(), end.numpy(), caps) == (
        tfm.batch_bfs_stats_device_plain(fmi.arrays, beg, end, fmi.sa_intv))
    lens = (end - beg).clamp(min=0).tolist()
    wide = sum(tree_bound(n, fmi.sa_intv) > m.wide for n in lens)
    assert m.spilled >= wide
    return want, m


@pytest.mark.parametrize("sa_intv", [2, 4, 8])
@pytest.mark.parametrize("n", [63, 127, 1023, 3000])
def test_model_equals_the_plain_bfs(n, sa_intv):
    """32-ordered builds of random texts whose N = n + 1 is a multiple of
    64 (a range endpoint at row N has no b_tab row) and of a repeat-heavy
    text (long ties left in another order than the full sort's): 30 ranges,
    four tiles, the wide ones and a full tile's on the spill route. At
    n = 3000 also kiss_tpu's positions (at N % 64 == 0 kiss_tpu clamps a
    gather and answers wrongly, test_torch_bfs.py)."""
    text = (oracle.repeat_heavy_dna(n, unit=40, seed=8) if n == 3000
            else oracle.random_dna(n, seed=n))
    fmi = tfm.FMIndex(sa_intv=sa_intv, device="cpu").build(text,
                                                          sort_len=32)
    assert fmi._routes_to_bfs()
    beg, end = _ranges(fmi, text, seed=n + sa_intv)
    pos, m = _check_model(fmi, beg, end)
    assert m.spilled > 0 and len(list(m.tiles(len(beg)))) > m.wave
    # the whole table's range gives every position once
    np.testing.assert_array_equal(np.sort(pos[-fmi.n_rows:].numpy()),
                                  np.arange(fmi.n_rows))
    if n == 3000:
        j = jfm.FMIndex(sa_intv=sa_intv, lookup_len=0).build(text,
                                                             sort_len=32)
        np.testing.assert_array_equal(
            pos.numpy().astype(np.uint32),
            j._bfs_positions(beg.numpy(), end.numpy()))


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
    pos, _ = _check_model(fmi, beg, end)
    np.testing.assert_array_equal(
        pos.numpy().astype(np.uint32),
        jf._bfs_positions(beg.numpy(), end.numpy()))


def test_model_outside_the_contract_reruns():
    """A 4-ordered index at sa_intv 8 queried with 9-mers (4 < 7 + 9: the
    BFS is not exact, and the plain version is the yardstick). Given one
    segment and one pool node, the segment launch runs again at the sizes
    it reports (the pool first, then the segments it finds with the whole
    pool) and the stats launch once more; the positions and stats are the
    plain version's."""
    text = oracle.repeat_heavy_dna(1500, unit=12, seed=5)
    fmi = tfm.FMIndex(sa_intv=8, device="cpu").build(text, sort_len=4)
    beg, end = _ranges(fmi, text, seed=11)
    want = tfm.bfs_locate_device_plain(fmi.arrays, beg, end, 8)
    assert want.shape[0] != int((end - beg).sum())  # outside the contract
    m = Model(fmi)
    np.testing.assert_array_equal(m.locate(beg.numpy(), end.numpy(), (1, 1)),
                                  want.numpy())
    assert m.launches == 3
    assert m.stats(beg.numpy(), end.numpy(), (1, 1)) == (
        tfm.batch_bfs_stats_device_plain(fmi.arrays, beg, end, 8))
    assert m.launches == 5


def test_bfs_until_it_fits_grows_to_the_reported_sizes():
    calls = []

    def run(seg_cap, pool_cap):
        calls.append((seg_cap, pool_cap))
        # the pool need is known at once, the segments once the pool fits
        return "result", (40 if pool_cap >= 9 else 3), 9

    assert tfm.bfs_until_it_fits(run, 5, 2) == "result"
    assert calls == [(5, 2), (5, 9), (40, 9)]
    assert tfm.bfs_guess(1000) == (6096, 66536)


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

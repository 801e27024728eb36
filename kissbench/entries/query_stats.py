"""Entry ``query_stats``: pattern batches against one index, each answered
with its occurrence total and location checksum, the two integers coming
back to the host.

Traffic keys: ``patterns`` a batch of length ``qlen`` (90% sampled from
the text, 10% random), ``pool`` distinct batches made from the seed,
packed two bits a character and kept on the card (the window cycles
through them); the index: ``sa_intv``, ``sort_len`` (null: the full
order; an integer: ``fmindex_build -k``), built in set-up by ``FMIndex.
build`` from the host text; ``locate``: ``walk`` (the per-row walk, K3
``batch_locate_stats_device``; needs the full order) or ``bfs`` (the range
BFS, K4 ``bfs_query_stats``). Each operation is ``get_range_packed_device``
(K2) and then the locate.

Checked: every pool batch's ranges from the last operation that ran it
(``range_rows_wrong``: patterns whose beg, end or offs differ) and every
operation's total and checksum (``stats_wrong``: operations whose pair
differs), both against the k-mer oracle; limit 0. The control is the
oracle's answers for the patterns one character short (the backward
search one LF step short).
"""

from __future__ import annotations

import numpy as np
import torch

from kissbench import bounds, reference
from kissbench.cell import Check, Context, load_kernels
from kissbench.synth import pack_queries_2bit, sample_patterns


class Cell:
    def __init__(self, ctx: Context):
        t = ctx.traffic
        self.ctx = ctx
        self.nq = int(t["patterns"])
        self.qlen = int(t["qlen"])
        self.sa_intv = int(t["sa_intv"])
        self.sort_len = t.get("sort_len")
        self.locate = t["locate"]
        if self.locate not in ("walk", "bfs"):
            raise ValueError(f"locate {self.locate!r}: walk or bfs")
        self.text_host = ctx.genome()
        self.work = self.nq
        self.patterns = [
            sample_patterns(self.text_host, self.nq, self.qlen,
                            seed=ctx.seed_of(1 + slot))
            for slot in range(int(t["pool"]))
        ]
        self.packed = [
            torch.from_numpy(pack_queries_2bit(p).view(np.int32))
            .to(ctx.device) for p in self.patterns
        ]
        self.index = None
        self.answers = []  # (slot, total, checksum) of each operation
        self.ranges = {}  # slot -> (beg, end, offs) of its last operation
        self.turn = 0
        self.oracle = None  # the reference's, made after the window

    def setup_program(self) -> None:
        from kiss_tpu_torch.models import fm_index as fm

        load_kernels(self.ctx)
        self.index = fm.FMIndex(sa_intv=self.sa_intv, lookup_len=0,
                                device=self.ctx.device)
        self.index.build(self.text_host, sort_len=self.sort_len)
        self.ctx.sync()

    def begin_window(self) -> None:
        self.answers = []

    def op(self) -> None:
        from kiss_tpu_torch.models import fm_index as fm

        slot = self.turn % len(self.packed)
        self.turn += 1
        a, blocks = self.index.arrays, self.index.blocks
        beg, end, offs = fm.get_range_packed_device(
            a, self.packed[slot], self.qlen, 0, blocks=blocks)
        stats = (fm.batch_locate_stats_device if self.locate == "walk"
                 else fm.bfs_query_stats)
        total, checksum = stats(a, beg, end, self.sa_intv, blocks=blocks)
        self.answers.append((slot, total, checksum))
        self.ranges[slot] = (beg, end, offs)

    def release(self) -> None:
        self.index = None
        self.packed = None

    def _oracle(self):
        if self.oracle is None:
            text = torch.from_numpy(self.text_host).to(self.ctx.device)
            self.oracle = reference.KmerOracle(text, self.qlen,
                                               self.sa_intv)
            self.want = [
                self.oracle.search(torch.from_numpy(p).to(self.ctx.device))
                for p in self.patterns
            ]
            self.want_stats = [self.oracle.stats(w[0], w[1])[:2]
                               for w in self.want]
        return self.oracle

    def _readings(self, ranges: dict, answers) -> list[Check]:
        self._oracle()
        rows = sum(reference.ranges_differ(got, self.want[slot][:3])
                   for slot, got in ranges.items())
        stats = sum(1 for slot, total, checksum in answers
                    if (total, checksum) != self.want_stats[slot])
        return [Check("range_rows_wrong", rows, 0),
                Check("stats_wrong", stats, 0)]

    def check(self) -> list[Check]:
        return self._readings(self.ranges, self.answers)

    def failed_ops(self, checks: list[Check]) -> int:
        """Operations whose answer is wrong (at least one where a range
        is)."""
        got = {c.name: c.value for c in checks}
        return max(got["stats_wrong"], int(got["range_rows_wrong"] > 0))

    def trace_work(self) -> dict:
        """The bounds of K2 and of the locate kernel over the traced
        operations, summed (ms), from the work the oracle counts."""
        oracle = self._oracle()
        sizes = bounds.IndexSizes.of(self.text_host.shape[0], self.sa_intv)
        qwords = self.nq * -(-self.qlen // 16)
        per_slot = []
        for beg, end, _, steps in self.want:
            k2 = bounds.k2_bound(sizes, self.nq, qwords, int(steps.sum()))[0]
            if self.locate == "walk":
                rows, _, walk = oracle.stats(beg, end)
                loc = bounds.k3_bound(sizes, 16 * self.nq + 8, walk, rows)[0]
            else:
                loc = bounds.k4_bound(sizes, self.nq,
                                      oracle.bfs_work(beg, end), True)[0]
            per_slot.append((k2, loc))
        out = {"k2_bound_ms": 0.0, f"{self.locate}_bound_ms": 0.0}
        for slot, _, _ in self.answers:
            out["k2_bound_ms"] += per_slot[slot][0]
            out[f"{self.locate}_bound_ms"] += per_slot[slot][1]
        return out

    def control(self) -> list[Check]:
        oracle = self._oracle()
        ranges, answers = {}, []
        for slot, p in enumerate(self.patterns):
            short = torch.from_numpy(p[:, 1:]).to(self.ctx.device)
            beg, end, offs, _ = oracle.search(short)
            ranges[slot] = (beg, end, offs)
            answers.append((slot, *oracle.stats(beg, end)[:2]))
        return self._readings(ranges, answers)

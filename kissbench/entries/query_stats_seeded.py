"""Entry ``query_stats_seeded``: pattern batches against an index with a
seed table, each answered with its occurrence total and location checksum,
the two integers coming back to the host.

The index is the configuration's ``index``: ``sa_intv``, ``sort_len``
(null, the full order: the per-row walk needs it) and ``lookup_len`` L,
built in set-up from the host text by ``FMIndex(sa_intv, lookup_len=L,
device).build(text)``, as ``fmindex_build -l L`` builds it: the sort, the
tables, the block table and the seed table (K2 over all 4^L seeds).
Traffic keys: ``patterns`` a batch of length ``qlen`` >= L (90% sampled
from the text, 10% random), ``pool`` distinct batches made from the seed,
packed two bits a character and kept on the card (the window cycles
through them; set-up runs each once). Each operation is
``get_range_packed_device`` seeded from the table (K2: ``lookup[key]``,
``lookup[key + 1]`` on the last L characters, then ``qlen - L`` LF steps)
and then the per-row walk's stats (K3 ``batch_locate_stats_device``).

Checked after the window against ``kissbench.reference_lookup``, limit 0
each: ``lookup_entries_wrong`` (entries of the program's seed table unlike
the reference's, all 4^L + 1), ``range_rows_wrong`` (patterns of the pool
whose beg, end or offs from the last operation that ran them differ from
the seeded search's) and ``stats_wrong`` (operations whose total or
checksum differs). The control is the reference one LF step short: each
seed's entry from its last L - 1 characters, and the seeded search of the
patterns without their first character.
"""

from __future__ import annotations

import numpy as np
import torch

from kissbench import bounds, reference
from kissbench import reference_lookup as lookup_ref
from kissbench.cell import Check, Context, load_kernels
from kissbench.synth import pack_queries_2bit, sample_patterns


class Cell:
    def __init__(self, ctx: Context):
        t, index = ctx.traffic, ctx.config["index"]
        self.ctx = ctx
        self.nq = int(t["patterns"])
        self.qlen = int(t["qlen"])
        self.sa_intv = int(index["sa_intv"])
        self.lookup_len = int(index["lookup_len"])
        if index.get("sort_len") is not None:
            raise ValueError("the per-row walk needs the full order "
                             "(index sort_len null)")
        if not 1 <= self.lookup_len <= self.qlen:
            raise ValueError(f"lookup_len {self.lookup_len} outside 1 .. "
                             f"qlen {self.qlen}")
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
        self.table = None  # the program's seed table, kept for the check
        self.answers = []  # (slot, total, checksum) of each operation
        self.ranges = {}  # slot -> (beg, end, offs) of its last operation
        self.turn = 0
        self.oracle = None  # the reference's, made after the window

    def setup_program(self) -> None:
        from kiss_tpu_torch.models import fm_index as fm

        load_kernels(self.ctx)
        self.index = fm.FMIndex(sa_intv=self.sa_intv,
                                lookup_len=self.lookup_len,
                                device=self.ctx.device)
        self.index.build(self.text_host, sort_len=None)
        # every batch of the pool once, so that no output of the window is
        # the first of its kind to take memory from the card
        for _ in self.packed:
            self.op()
        self.ctx.sync()

    def begin_window(self) -> None:
        self.answers = []

    def op(self) -> None:
        from kiss_tpu_torch.models import fm_index as fm

        slot = self.turn % len(self.packed)
        self.turn += 1
        a, blocks = self.index.arrays, self.index.blocks
        beg, end, offs = fm.get_range_packed_device(
            a, self.packed[slot], self.qlen, self.lookup_len, blocks=blocks)
        total, checksum = fm.batch_locate_stats_device(
            a, beg, end, self.sa_intv, blocks=blocks)
        self.answers.append((slot, total, checksum))
        self.ranges[slot] = (beg, end, offs)

    def release(self) -> None:
        self.table = self.index.arrays.lookup
        self.index = None
        self.packed = None

    def _oracle(self):
        if self.oracle is None:
            dev = self.ctx.device
            text = torch.from_numpy(self.text_host).to(dev)
            self.oracle = reference.KmerOracle(text, self.qlen,
                                               self.sa_intv)
            self.want_table = lookup_ref.seed_table(self.oracle,
                                                    self.lookup_len)
            self.want = [
                lookup_ref.seeded_search(self.oracle, self.want_table,
                                         self.lookup_len,
                                         torch.from_numpy(p).to(dev))
                for p in self.patterns
            ]
            self.want_stats = [self.oracle.stats(w[0], w[1])[:2]
                               for w in self.want]
        return self.oracle

    def _readings(self, table, ranges: dict, answers) -> list[Check]:
        self._oracle()
        entries = reference.tables_differ({"lookup": table},
                                          {"lookup": self.want_table})
        rows = sum(reference.ranges_differ(got, self.want[slot][:3])
                   for slot, got in ranges.items())
        stats = sum(1 for slot, total, checksum in answers
                    if (total, checksum) != self.want_stats[slot])
        return [Check("lookup_entries_wrong", entries, 0),
                Check("range_rows_wrong", rows, 0),
                Check("stats_wrong", stats, 0)]

    def check(self) -> list[Check]:
        return self._readings(self.table, self.ranges, self.answers)

    def failed_ops(self, checks: list[Check]) -> int:
        """Operations whose answer is wrong (at least one where a range or
        a table entry is)."""
        got = {c.name: c.value for c in checks}
        return max(got["stats_wrong"], int(got["range_rows_wrong"] > 0),
                   int(got["lookup_entries_wrong"] > 0))

    def trace_work(self) -> dict:
        """The bounds of K2 and K3 over the traced operations, summed (ms),
        from the work the reference counts (K2: the seeded LF steps and the
        two seed-table entries a pattern reads), and for each traced
        operation K2's patterns, query words and seeded LF steps with the
        index's sizes (``k2_ops``, ``k2_sizes``), for a reader that takes
        the seed reads from the program's counter."""
        oracle = self._oracle()
        sizes = bounds.IndexSizes.of(self.text_host.shape[0], self.sa_intv,
                                     self.lookup_len)
        qwords = self.nq * -(-self.qlen // 16)
        per_slot = []
        for beg, end, _, steps in self.want:
            lf_steps = int(steps.sum())
            k2 = bounds.k2_bound(sizes, self.nq, qwords, lf_steps,
                                 2 * self.nq)[0]
            rows, _, walk = oracle.stats(beg, end)
            k3 = bounds.k3_bound(sizes, 16 * self.nq + 8, walk, rows)[0]
            per_slot.append((k2, k3, lf_steps))
        out = {"k2_bound_ms": 0.0, "walk_bound_ms": 0.0, "k2_ops": [],
               "k2_sizes": sizes}
        for slot, _, _ in self.answers:
            k2, k3, lf_steps = per_slot[slot]
            out["k2_bound_ms"] += k2
            out["walk_bound_ms"] += k3
            out["k2_ops"].append((self.nq, qwords, lf_steps))
        return out

    def control(self) -> list[Check]:
        oracle = self._oracle()
        ranges, answers = {}, []
        for slot, p in enumerate(self.patterns):
            short = torch.from_numpy(p[:, 1:]).to(self.ctx.device)
            beg, end, offs, _ = lookup_ref.seeded_search(
                oracle, self.want_table, self.lookup_len, short)
            ranges[slot] = (beg, end, offs)
            answers.append((slot, *oracle.stats(beg, end)[:2]))
        return self._readings(
            lookup_ref.short_seed_table(oracle, self.lookup_len), ranges,
            answers)

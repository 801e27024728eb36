"""Entry ``build``: the FM-index build, one after another, from the text
on the host as users call it: ``FMIndex(sa_intv, lookup_len=0,
device).build(text)``, the CLI's ``fmindex_build``
instantiation (the sort, the tables, the block table, the lookup), each
synced and dropped before the next.

Traffic keys: ``sa_intv``, and for the check ``check_patterns`` patterns
of length ``qlen``. The build sorts the full order and builds no lookup
table (``fmindex_build``'s defaults).

Checked (``index_entries_wrong``, limit 0): every entry of the ``.fmi``
tables of the window's last index against the reference's, and the
ranges that the program's backward search (K2, through the index's block
table) gives for a batch of patterns against the reference's. The control
is the reference built on a suffix array sorted to 256 characters only.
"""

from __future__ import annotations

import numpy as np
import torch

from kissbench import reference
from kissbench.cell import Check, Context, load_kernels
from kissbench.synth import pack_queries_2bit, sample_patterns

CHECK_TAG = 1000


class Cell:
    def __init__(self, ctx: Context):
        t = ctx.traffic
        self.ctx = ctx
        self.sa_intv = int(t["sa_intv"])
        self.qlen = int(t["qlen"])
        self.text_host = ctx.genome()
        self.work = self.text_host.shape[0]
        self.patterns = sample_patterns(
            self.text_host, int(t["check_patterns"]), self.qlen,
            seed=ctx.seed_of(CHECK_TAG))
        self.index = None

    def setup_program(self) -> None:
        load_kernels(self.ctx)

    def begin_window(self) -> None:
        pass

    def op(self) -> None:
        from kiss_tpu_torch.models import fm_index as fm

        self.index = None
        self.index = fm.FMIndex(sa_intv=self.sa_intv, lookup_len=0,
                                device=self.ctx.device).build(self.text_host)
        self.ctx.sync()

    def release(self) -> None:
        """Keep the last index's tables and the ranges its backward search
        gives for the check's patterns; drop the rest."""
        from kiss_tpu_torch.models import fm_index as fm

        idx = self.index
        qw = torch.from_numpy(pack_queries_2bit(self.patterns)
                              .view(np.int32)).to(self.ctx.device)
        self.got_ranges = fm.get_range_packed_device(
            idx.arrays, qw, self.qlen, 0, blocks=idx.blocks)
        self.got_tables = {
            name: (reference.unsigned_words(getattr(idx.arrays, name))
                   if name in ("bwt_words", "b_words")
                   else getattr(idx.arrays, name))
            for name in reference.TABLES
        }
        self.index = None

    def _readings(self, tables: dict, ranges) -> list[Check]:
        text = torch.from_numpy(self.text_host).to(self.ctx.device)
        sa = reference.suffix_array(text, None)
        want = reference.fm_tables(text, sa, self.sa_intv)
        del sa
        wrong = reference.tables_differ(tables, want)
        del want
        oracle = reference.KmerOracle(text, self.qlen, self.sa_intv)
        pats = torch.from_numpy(self.patterns).to(self.ctx.device)
        wrong += reference.ranges_differ(ranges, oracle.search(pats)[:3])
        return [Check("index_entries_wrong", wrong, 0)]

    def check(self) -> list[Check]:
        return self._readings(self.got_tables, self.got_ranges)

    def failed_ops(self, checks: list[Check]) -> int:
        """The window's last operation, the one judged, if it is wrong."""
        return int(any(c.value > c.limit for c in checks))

    def trace_work(self) -> dict:
        return {}

    def control(self) -> list[Check]:
        text = torch.from_numpy(self.text_host).to(self.ctx.device)
        short = reference.suffix_array(text, 256)
        tables = reference.fm_tables(text, short, self.sa_intv)
        del short
        pats = torch.from_numpy(self.patterns).to(self.ctx.device)
        return self._readings(tables,
                              reference.backward_search(tables, pats))

"""Entry ``sort``: the library sort, one k-ordered suffix array after
another of the text resident on the card, each left there and synced.

Traffic keys: ``k`` (the order; -1 for the full order) and ``strategy``
(``wide``, PARALLEL_SORTING; ``doubling``, PREFIX_DOUBLING). The timed call
is ``k_ordered_suffix_array(text, k, as_numpy=False, strategy=...)``, the
library entry that the CLI's ``suffix_sort`` and the index build use. Each
SA is dropped before the next call, so the peak is one sort's own.

Checked: the whole SA of the window's last sort against the reference's
(rows that differ; limit 0). The control is the reference sorted one
doubling short (k / 2, or 256 characters where the order is full).
"""

from __future__ import annotations

import torch

from kissbench import reference
from kissbench.cell import Check, Context, load_kernels


def _order(k: int) -> int | None:
    return None if k < 0 else k


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.k = int(ctx.traffic["k"])
        self.strategy = ctx.traffic.get("strategy", "wide")
        self.text = torch.from_numpy(ctx.genome()).to(ctx.device)
        self.work = self.text.shape[0]
        self.sa = None

    def setup_program(self) -> None:
        load_kernels(self.ctx)

    def begin_window(self) -> None:
        pass

    def op(self) -> None:
        from kiss_tpu_torch.ops import suffix_sort

        self.sa = None
        self.sa = suffix_sort.k_ordered_suffix_array(
            self.text, self.k, as_numpy=False, strategy=self.strategy,
            device=self.ctx.device)
        self.ctx.sync()

    def release(self) -> None:
        pass  # the SA is the output judged; the text is the input

    def _compare(self, sa: torch.Tensor) -> list[Check]:
        want = reference.suffix_array(self.text, _order(self.k))
        wrong = (int((sa.to(torch.int64) != want).sum())
                 if sa.shape == want.shape else want.numel())
        return [Check("sa_rows_wrong", wrong, 0)]

    def check(self) -> list[Check]:
        return self._compare(self.sa)

    def failed_ops(self, checks: list[Check]) -> int:
        """The window's last operation, the one judged, if it is wrong."""
        return int(any(c.value > c.limit for c in checks))

    def trace_work(self) -> dict:
        return {}

    def control(self) -> list[Check]:
        k = _order(self.k)
        short = reference.suffix_array(self.text, 256 if k is None else
                                       max(k // 2, 1))
        return self._compare(short)

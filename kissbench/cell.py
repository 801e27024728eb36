"""What every entry (``entries/<entry>.py``) is handed and hands back.

An entry module defines ``Cell(ctx)``: its constructor makes the cell's
inputs from the seed (``ctx``); ``setup_program()`` builds what the
program needs before the window (the kernels, an index); ``op()`` runs
one whole operation and returns when its result is ready on the card;
``work`` is the units of work one operation does (characters, patterns);
``begin_window()`` clears what the warm operation left in its log;
``release()`` frees the program's state except the outputs to be judged;
``check()`` compares those outputs with the plain reference and returns
:class:`Check` readings, ``failed_ops(checks)`` how many operations they
show wrong; ``trace_work()`` gives the per-layer readers the
work the traced operations needed (bounds in milliseconds); ``control()``
returns the readings that the control, the reference put in the
program's place one step short, gives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from kissbench.synth import synth_genome


class Check(NamedTuple):
    """A number compared with the reference, and its limit: the run is
    correct when every value is at or below its limit."""

    name: str
    value: int
    limit: int


@dataclass
class Context:
    """One run's configuration, traffic mix, seed and device."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    _genome: np.ndarray | None = field(default=None, repr=False)

    def seed_of(self, tag: int) -> np.random.SeedSequence:
        """The seed of one input of the run (0: the genome; the others as
        the entry numbers them): the same run seed gives the same
        inputs."""
        return np.random.SeedSequence(self.seed % 2**64, spawn_key=(tag,))

    def genome(self) -> np.ndarray:
        """The configuration's text (int8, host), made once a run."""
        if self._genome is None:
            self._genome = synth_genome(int(self.config["n"]),
                                        self.seed_of(0))
        return self._genome

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_kernels(ctx: Context) -> None:
    """Build or load the program's kernels (a CPU run uses the plain
    versions and loads none)."""
    if ctx.device.type == "cuda":
        from kiss_tpu_torch import kernels

        kernels.library()

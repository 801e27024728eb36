"""The control of each cell's comparison fails it: the reference put in
the program's place one step short reads above the limit, at a size with
the genome model's repeats (they start past 2^21 characters) that a test
run can hold."""

from __future__ import annotations

import json

import pytest
import torch

from kissbench.cell import Context
from kissbench.run import Bench
from kissbench.tests import helpers


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.tiny_root(str(tmp_path_factory.mktemp("control")),
                             n=2_400_000, patterns=3000)


@pytest.mark.parametrize("workload", helpers.CELLS)
def test_the_control_fails_its_check(root, workload):
    bench = Bench.load(root, workload)
    entry = bench.module("entries", bench.traffic["entry"])
    for seed in (5, 2**31 + 7):
        cell = entry.Cell(Context(workload, bench.config, bench.traffic,
                                  seed, torch.device("cpu")))
        checks = cell.control()
        assert any(c.value > c.limit for c in checks), json.dumps(checks)

"""The harness on the card at a small size, through the program's CUDA
kernels: every cell runs and is correct, traced and untraced, with the
kernels' per-layer metrics present in the traced line; a planted fault
comes out not correct. Marked ``cuda``; each test skips where no card is
found (decided inside the test). On the card:

    python -m pytest --noconftest -m cuda kissbench/tests/test_kissbench_card.py
"""

from __future__ import annotations

import json
import os

import pytest

from kissbench.tests import helpers

pytestmark = pytest.mark.cuda


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.tiny_root(str(tmp_path_factory.mktemp("card")),
                             n=2_400_000, patterns=50_000)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", helpers.CELLS)
def test_cell_on_the_card(root, workload, trace):
    _need_card()
    rc, out, err = helpers.run(root, workload, trace=trace, seconds=1.0,
                               device="cuda")
    assert rc == 0, err[-3000:]
    line = helpers.last_line(out)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    with open(os.path.join(helpers.REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    group = spec["per_layer"] if trace else spec["end_to_end"]
    want = {m["name"] for m in group
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100


@pytest.mark.parametrize("workload,fault", [
    ("dmel48m.sort_k256", "sort_swap"),
    ("chm13chr1.build_full", "build_table_entry"),
    ("dmel48m.query_walk_stats", "query_checksum"),
    ("chm13chr1.query_bfs_stats", "query_batch_half"),
])
def test_a_fault_on_the_card_is_not_correct(root, workload, fault):
    _need_card()
    rc, out, err = helpers.run(root, workload, fault=fault, seconds=0.5,
                               device="cuda")
    assert rc == 0, err[-3000:]
    assert helpers.last_line(out)["correct"] is False

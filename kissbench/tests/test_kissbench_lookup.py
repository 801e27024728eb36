"""The seeded-search cell (``dmel48m.query_walk_lookup12``) on the CPU at
a tiny size, its configuration's ``lookup_len`` cut to 6: it runs correct
traced and untraced, its control fails every check, a search that skips
the seed and a seed table with one entry altered are not correct, the
per-layer reader reads the program's counter, and the plain reference and
the entry load nothing of the program or of JAX. One test runs the cell
on the card with the full 12-deep table (marked ``cuda``; it skips where
no card is found, decided inside the test):

    python -m pytest --noconftest -m cuda kissbench/tests/test_kissbench_lookup.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from kissbench.tests import helpers

CELL = "dmel48m.query_walk_lookup12"
CONFIG = os.path.join("kissbench", "configs", "dmel-chr1_2-48m-lut12.json")


def _root(path: str, lookup_len: int, **cut) -> str:
    root = helpers.tiny_root(path, **cut)
    with open(os.path.join(root, CONFIG)) as f:
        index = json.load(f)["index"]
    helpers.edit_json(os.path.join(root, CONFIG),
                      index=dict(index, lookup_len=lookup_len))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _root(str(tmp_path_factory.mktemp("lookup")), 6)


# Faults planted underneath the timed path (applied in the run's process
# before the harness starts).
def _skip_the_seed():
    """K2 launched with lookup_len 0 while the index holds its table."""
    from kiss_tpu_torch.models import fm_index as fm

    inner = fm.get_range_packed_device

    def wrapped(idx, qwords, qlen, lookup_len, *a, **k):
        return inner(idx, qwords, qlen, 0, *a, **k)

    fm.get_range_packed_device = wrapped


def _table_entry():
    """One entry of the built seed table altered."""
    from kiss_tpu_torch.models import fm_index as fm

    inner = fm.FMIndex.build

    def wrapped(self, *a, **k):
        index = inner(self, *a, **k)
        lookup = index.arrays.lookup.clone()
        lookup[lookup.shape[0] // 3] += 1
        index.arrays = index.arrays._replace(lookup=lookup)
        return index

    fm.FMIndex.build = wrapped


FAULTS = {"skip_the_seed": _skip_the_seed, "table_entry": _table_entry}


def _run(root, *, trace=0, fault=None, device="cpu", seconds=0.5):
    args = ["--workload", CELL, "--seed", "4294967311", "--seconds",
            str(seconds), "--trace", str(trace), "--device", device,
            "--root", root]
    code = ("import sys\n"
            "from kissbench.tests import test_kissbench_lookup as t\n"
            f"fault = {fault!r}\n"
            "if fault is not None:\n"
            "    t.FAULTS[fault]()\n"
            "from kissbench.run import main\n"
            f"sys.exit(main({args!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return helpers.last_line(proc.stdout)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct(root, trace):
    line = _run(root, trace=trace)
    assert line["correct"] is True and line["failed"] == 0
    assert list(line["checks"]) == ["lookup_entries_wrong",
                                    "range_rows_wrong", "stats_wrong"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    # the CPU runs no device kernel, so the traced readers find nothing
    want = set() if trace else {"query_Mpat_s", "setup_s"}
    assert set(line["metrics"]) == want


def test_the_control_fails_every_check(root):
    proc = subprocess.run(
        [sys.executable, "-m", "kissbench.control", "--workload", CELL,
         "--seeds", "5,2147483655", "--device", "cpu", "--root", root],
        cwd=helpers.REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert lines[-1] == {"all_fail": True}
    for line in lines[:-1]:
        assert all(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("fault,check", [
    ("skip_the_seed", "range_rows_wrong"),
    ("table_entry", "lookup_entries_wrong"),
])
def test_a_fault_is_not_correct(root, fault, check):
    line = _run(root, fault=fault)
    assert line["correct"] is False and line["failed"] >= 1
    assert line["checks"][check]["value"] >= 1


def test_the_reader_reads_the_programs_counter(root):
    """k2_roofline.lookup: the bound over the seeded LF steps and two
    entries a counted seed lookup, over fm_search.cu's device time; None
    without the counter, or with it at 0 (a search that skips the seed)."""
    from torch.profiler import ProfilerActivity, profile

    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.utils import timing
    from kissbench import bounds, trace
    from kissbench.cell import Context
    from kissbench.run import Bench

    bench = Bench.load(root, CELL)
    cell = bench.module("entries", bench.traffic["entry"]).Cell(
        Context(CELL, bench.config, bench.traffic, 9, torch.device("cpu")))
    cell.setup_program()
    reader = bench.module("metrics", "k2_roofline.lookup")
    s = trace.Summary(window_s=1.0, busy_s=0.5, ops=3,
                      device_s={("backward_search_kernel", "fm_search.cu"):
                                2e-3})
    timing.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            fm.get_range_packed_device(cell.index.arrays, cell.packed[0], 25,
                                       0, blocks=cell.index.blocks)
        unseeded = list(timing.RECORDS)
        assert timing.span_summary()["kiss.query.search"]["counts"] == {
            "k2_queries": 1500, "k2_lookup_reads": 0}
        timing.reset_spans()
        cell.begin_window()
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                cell.op()
        cell.release()
        work = cell.trace_work()
        sizes = bounds.IndexSizes.of(20000, 4, 6)
        assert work["k2_sizes"] == sizes and len(work["k2_ops"]) == 3
        assert work["k2_ops"][0][:2] == (1500, 3000)
        bound = sum(bounds.k2_bound(sizes, nq, qwords, steps, 2 * nq)[0]
                    for nq, qwords, steps in work["k2_ops"])
        assert bound == pytest.approx(work["k2_bound_ms"], rel=1e-12)
        assert reader.read(s, work) == pytest.approx(100 * bound / 2.0,
                                                     rel=1e-12)
        timing.reset_spans()
        assert reader.read(s, work) is None  # no counter
        timing.RECORDS.extend(unseeded)
        assert reader.read(s, work) is None  # the counter at 0
    finally:
        timing.reset_spans()


def test_the_reference_and_the_entry_load_nothing_forbidden():
    code = (
        "import sys\n"
        "import kissbench.reference_lookup\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert not loaded & {"kiss_tpu_torch", "kiss_tpu", "jax", "jaxlib"}
    # a whole run ends with the harness's own check of the modules it
    # holds: it gives no line (exit code 3) where one is forbidden
    code = ("import sys\n"
            "from kissbench.run import FORBIDDEN, load_file\n"
            f"load_file({os.path.join(helpers.REPO, 'kissbench', 'entries', 'query_stats_seeded.py')!r}, 'e')\n"
            f"load_file({os.path.join(helpers.REPO, 'kissbench', 'metrics', 'k2_roofline.lookup.py')!r}, 'm')\n"
            "import kiss_tpu_torch.models.fm_index\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules}"
            " & set(FORBIDDEN))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == []


@pytest.mark.cuda
def test_the_cell_on_the_card(tmp_path):
    """The full 12-deep table over 2.4M characters through the kernels:
    correct, and k2_roofline.lookup in the traced line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    root = _root(str(tmp_path), 12, n=2_400_000, patterns=50_000)
    line = _run(root, device="cuda", seconds=1.0)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"query_Mpat_s", "setup_s"}
    line = _run(root, trace=1, device="cuda", seconds=1.0)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"k2_roofline.lookup"}
    assert 0 < line["metrics"]["k2_roofline.lookup"]["value"] <= 100

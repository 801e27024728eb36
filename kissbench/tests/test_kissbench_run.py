"""The harness on the CPU at a tiny size (the program's plain versions):
every cell runs and is correct, its last line has the contract's keys,
planted faults make ``correct`` false, a new configuration, traffic mix
and metric are data files alone, and no forbidden module is loaded."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from kissbench.tests import helpers

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.tiny_root(str(tmp_path_factory.mktemp("kissbench")))


def _spec():
    with open(os.path.join(helpers.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", helpers.CELLS)
def test_cell_runs_correct_with_the_contract_keys(root, workload, trace):
    rc, out, err = helpers.run(root, workload, trace=trace)
    assert rc == 0, err[-3000:]
    line = helpers.last_line(out)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    spec = _spec()
    group = spec["per_layer"] if trace else spec["end_to_end"]
    names = {m["name"] for m in group
             if workload in m.get("workloads", [workload])}
    # the CPU runs no device kernel, so the traced readers find nothing
    assert set(line["metrics"]) == (set() if trace else names)
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0


FAULTS = [
    ("dmel48m.sort_k256", "sort_swap"),
    ("dmel48m.sort_k256", "sort_unchanged"),
    ("dmel48m.sort_k256", "sort_half"),
    ("chm13chr1.build_full", "build_table_entry"),
    ("chm13chr1.build_full", "build_lf_rows"),
    ("chm13chr1.build_full", "build_samples_half"),
    ("chm13chr1.build_full", "build_unchanged"),
    ("dmel48m.query_walk_stats", "query_checksum"),
    ("dmel48m.query_walk_stats", "query_batch_half"),
    ("dmel48m.query_walk_stats", "query_search_unchanged"),
    ("chm13chr1.query_bfs_stats", "query_checksum"),
    ("chm13chr1.query_bfs_stats", "query_batch_half"),
    ("chm13chr1.query_bfs_stats", "query_search_unchanged"),
]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(root, workload, fault):
    rc, out, err = helpers.run(root, workload, fault=fault)
    assert rc == 0, err[-3000:]
    line = helpers.last_line(out)
    assert line["correct"] is False
    assert line["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_no_cuda_no_result(root):
    rc, out, _ = helpers.run(root, "dmel48m.sort_k256", device="cuda")
    assert rc != 0 and out.strip() == ""


def test_alone_in_an_empty_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder
    (no program) gives no result."""
    shutil.copy(os.path.join(helpers.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(helpers.REPO, "kissbench"),
                    tmp_path / "kissbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "kissbench.run", "--workload",
         "dmel48m.sort_k256", "--seed", "1", "--seconds", "1", "--trace",
         "0", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_new_cell_is_data_files_alone(root, tmp_path):
    """A configuration, a traffic mix, an end-to-end metric and a
    per-layer metric added as files plus BENCHMARK.json entries run
    without an edit to any file that is there."""
    new = helpers.tiny_root(str(tmp_path))
    helpers.write_json(
        os.path.join(new, "kissbench", "configs", "tiny-extra.json"),
        {"name": "tiny-extra", "n": 30000})
    helpers.write_json(
        os.path.join(new, "kissbench", "traffic", "sort_k64_doubling.json"),
        {"entry": "sort", "k": 64, "strategy": "doubling"})
    with open(os.path.join(new, "kissbench", "metrics", "ops_traced.py"),
              "w") as f:
        f.write("SOURCE, LAYER, UNIT, MOVES = 'program_counter', "
                "'device', 'ops', 'sort_Mbp_s'\n\n"
                "def read(s, work):\n    return s.ops\n")
    spec_path = os.path.join(new, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-extra", "source": "test",
                            "file": "kissbench/configs/tiny-extra.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.sort_k64", "config":
                              "tiny-extra", "traffic": "sort_k64_doubling",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("sort_Mbp_s", "peak_B_per_char"):
            m["workloads"].append("tiny.sort_k64")
    spec["per_layer"].append({"name": "ops_traced", "unit": "ops",
                              "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "sort_Mbp_s",
                              "workloads": ["tiny.sort_k64"]})
    helpers.write_json(spec_path, spec)
    rc, out, err = helpers.run(new, "tiny.sort_k64")
    assert rc == 0, err[-3000:]
    line = helpers.last_line(out)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"sort_Mbp_s", "peak_B_per_char",
                                    "setup_s"}
    rc, out, err = helpers.run(new, "tiny.sort_k64", trace=1)
    assert rc == 0, err[-3000:]
    line = helpers.last_line(out)
    assert line["metrics"]["ops_traced"]["value"] == line["attempted"]


FORBIDDEN = {"jax", "jaxlib", "flax", "kiss_tpu", "bench", "experiments",
             "tools"}


def test_the_harness_loads_no_forbidden_module(root):
    """Every module of the benchmark, every file it loads by name, and a
    whole run of each cell leave no module of those top-level names."""
    code = (
        "import glob, os, sys\n"
        "import kissbench.run as run, kissbench.control, kissbench.trace\n"
        "import kissbench.readers, kissbench.reference, kissbench.bounds\n"
        f"root = {helpers.REPO!r}\n"
        "for kind in ('entries', 'e2e', 'metrics'):\n"
        "    for p in glob.glob(os.path.join(root, 'kissbench', kind,"
        " '*.py')):\n"
        "        run.load_file(p, 'm_' + kind + os.path.basename(p)"
        ".replace('.', '_'))\n"
        "import kiss_tpu_torch.models.fm_index, kiss_tpu_torch.kernels\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert not set(proc.stdout.split()) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport kissbench.reference, kissbench.synth, "
            "kissbench.bounds\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "kiss_tpu_torch" not in proc.stdout.split()


def test_metric_files_agree_with_benchmark_json():
    """Each reader names the source, layer, unit and moved metric that
    BENCHMARK.json gives it; each configuration, traffic and metric
    named there has its file."""
    from kissbench.run import load_file

    spec = _spec()
    for m in spec["per_layer"]:
        mod = load_file(os.path.join(helpers.REPO, "kissbench", "metrics",
                                     m["name"] + ".py"), "m_" + m["name"])
        assert (mod.SOURCE, mod.LAYER, mod.UNIT, mod.MOVES) == (
            m["source"], m["layer"], m["unit"], m["moves"])
    for m in spec["end_to_end"]:
        assert os.path.isfile(os.path.join(helpers.REPO, "kissbench", "e2e",
                                           m["name"] + ".py"))
    for w in spec["workloads"]:
        assert os.path.isfile(os.path.join(helpers.REPO, "kissbench",
                                           "traffic", w["traffic"] + ".json"))

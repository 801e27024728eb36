"""A benchmark root at a tiny size for the CPU tests: ``BENCHMARK.json``
and copies of the data folders, with every configuration's ``n`` and
every traffic's batch cut, and ways to run the harness on it in a fresh
process (the tests' own process holds JAX, which a run refuses)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FOLDERS = ("configs", "traffic", "e2e", "metrics", "entries")
CELLS = ("dmel48m.sort_k256", "dmel48m.query_walk_stats",
         "chm13chr1.build_full", "chm13chr1.query_bfs_stats")


def tiny_root(path: str, n: int = 20000, patterns: int = 1500) -> str:
    """A root under ``path`` whose texts have ``n`` characters and whose
    batches ``patterns`` patterns; returns it."""
    root = os.path.join(path, "root")
    for folder in FOLDERS:
        shutil.copytree(os.path.join(REPO, "kissbench", folder),
                        os.path.join(root, "kissbench", folder))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for conf in spec["configs"]:
        edit_json(os.path.join(root, conf["file"]), n=n)
    tdir = os.path.join(root, "kissbench", "traffic")
    for name in os.listdir(tdir):
        with open(os.path.join(tdir, name)) as f:
            traffic = json.load(f)
        cut = {k: patterns for k in ("patterns", "check_patterns")
               if k in traffic}
        edit_json(os.path.join(tdir, name), **cut)
    write_json(os.path.join(root, "BENCHMARK.json"), spec)
    return root


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def edit_json(path: str, **changes) -> None:
    with open(path) as f:
        obj = json.load(f)
    obj.update(changes)
    write_json(path, obj)


def run(root: str, workload: str, *, seed: int = 4294967311,
        seconds: float = 0.5, trace: int = 0, fault: str | None = None,
        device: str = "cpu", cwd: str = REPO, env=None):
    """Run the harness on ``root`` in a fresh process (with ``fault`` from
    :mod:`kissbench.tests.faults` applied first): (exit code, stdout,
    stderr)."""
    args = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", device,
            "--root", root]
    code = ("import sys\n"
            "from kissbench.tests import faults\n"
            f"faults.apply({fault!r})\n"
            "from kissbench.run import main\n"
            f"sys.exit(main({args!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])

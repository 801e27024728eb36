"""The port's benchmark (``kiss_tpu_torch/bench.py``) on the CPU at a small
size, against the repository's ``bench.py`` and ``kiss_tpu``: the names,
units, extra fields and order of the metrics in its JSON line equal
``bench.py``'s (read from its source), its occurrences and checksum equal
``kiss_tpu``'s ``FMIndex.batch_query_stats`` on the same text and
patterns, the lookup counts equal the lookup-0 counts, a mismatch between
routes raises, and the module imports nothing of JAX. ``bench.py`` is
read, never imported: nothing here starts JAX work but ``kiss_tpu``'s
own build."""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from kiss_tpu_torch import bench
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.utils import native, synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SMALL, NQ_SMALL, L_SMALL = 30_000, 2_000, 6
ARGV = ["--device", "cpu", "--n", str(N_SMALL), "--nq", str(NQ_SMALL),
        "--lookup-len", str(L_SMALL)]
STANDARD_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _bench_py_metrics():
    """[(name, unit, extra field names)] of ``bench.py``'s JSON line in
    its order: the headline, then every ``m(...)`` call of ``main``."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    head, out = [], []

    class Visitor(ast.NodeVisitor):  # depth first, in source order
        def visit_Call(self, node):
            if isinstance(node.func, ast.Name) and node.func.id == "m":
                out.append((node.args[0].value, node.args[2].value,
                            {kw.arg for kw in node.keywords}))
            self.generic_visit(node)

        def visit_Dict(self, node):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys and "extra_metrics" in keys:
                vals = dict(zip(keys, node.values))
                head.append((vals["metric"].value, vals["unit"].value, set()))
            self.generic_visit(node)

    Visitor().visit(main)
    return head + out


@pytest.fixture(scope="module")
def run():
    """One run of ``bench.main`` at the small size: (its JSON line, the
    counts of every ``counts_packed_device`` call by lookup length)."""
    calls = []
    counts = fm.counts_packed_device

    def recorded(idx, qwords, qlen, lookup_len, **kw):
        c = counts(idx, qwords, qlen, lookup_len, **kw)
        calls.append((lookup_len, c.clone()))
        return c

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(fm, "counts_packed_device", recorded)
        assert bench.main(ARGV) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0]), calls


def test_metrics_are_bench_pys_in_order(run):
    line, _ = run
    got = [(line["metric"], line["unit"],
            set(line) - STANDARD_KEYS - {"extra_metrics", "device"})]
    got += [(e["metric"], e["unit"], set(e) - STANDARD_KEYS)
            for e in line["extra_metrics"]]
    want = _bench_py_metrics()
    assert native.available()  # so the LMS metric is in both lines
    assert len(want) == 14
    assert got == want
    assert line["device"] == "cpu"
    assert line["vs_baseline"] == round(line["value"] / bench.BASELINE_MBP_S,
                                        3)
    for e in line["extra_metrics"]:
        assert e["vs_baseline"] is None
        assert np.isfinite(e["value"]) and e["value"] > 0, e


def test_occurrences_and_checksum_equal_kiss_tpu(run):
    from kiss_tpu.models import fm_index as jfm

    line, _ = run
    counts = next(e for e in line["extra_metrics"]
                  if e["metric"] == "fmindex_query_1M_len25_counts_per_s")
    text = synth.synth_genome(N_SMALL, 0)
    pats = synth.sample_patterns(text, NQ_SMALL, bench.QLEN, seed=7)
    want = jfm.FMIndex(sa_intv=4, lookup_len=0).build(text) \
        .batch_query_stats(pats)
    assert (counts["occ"], counts["checksum"]) == tuple(map(int, want))
    assert counts["occ"] > 0


def test_lookup_counts_equal_lookup_0_counts(run):
    _, calls = run
    by_len = {}
    for lookup_len, c in calls:
        by_len.setdefault(lookup_len, []).append(c)
    assert set(by_len) == {0, L_SMALL}
    # the warm call and the 3 timed ones of each
    assert len(by_len[0]) == len(by_len[L_SMALL]) == 4
    for c in by_len[0] + by_len[L_SMALL]:
        assert c.shape == (NQ_SMALL,) and torch.equal(c, by_len[0][0])


def test_a_lookup_count_that_differs_raises(monkeypatch):
    counts = fm.counts_packed_device

    def off_by_one(idx, qwords, qlen, lookup_len, **kw):
        c = counts(idx, qwords, qlen, lookup_len, **kw)
        return c + 1 if lookup_len else c

    monkeypatch.setattr(fm, "counts_packed_device", off_by_one)
    text = synth.synth_genome(3000, 1)
    with pytest.raises(RuntimeError, match="lookup-4 counts differ"):
        bench.bench_fmindex(torch.from_numpy(text), text, nq=200,
                            lookup_len=4)


def test_a_stats_route_that_differs_raises(monkeypatch):
    monkeypatch.setattr(fm, "bfs_query_stats",
                        lambda *a, **kw: (0, 0))
    text = synth.synth_genome(3000, 1)
    with pytest.raises(RuntimeError, match="BFS stats"):
        bench.bench_fmindex(torch.from_numpy(text), text, nq=200,
                            lookup_len=4)


def test_imports_nothing_of_jax():
    tree = ast.parse(open(os.path.join(ROOT, "kiss_tpu_torch",
                                       "bench.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert mods and all(m.split(".")[0] not in
                        {"jax", "jaxlib", "kiss_tpu", "bench", "experiments"}
                        for m in mods), mods


def test_main_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main([])


def test_a_device_path_sa_that_differs_raises(monkeypatch):
    sort = bench.k_ordered_suffix_array

    def swapped(text, k, **kw):
        sa = sort(text, k, **kw).clone()
        sa[[1, 2]] = sa[[2, 1]]
        return sa

    monkeypatch.setattr(bench, "k_ordered_suffix_array", swapped)
    text = torch.from_numpy(synth.synth_genome(3000, 1))
    with pytest.raises(RuntimeError, match="device-path SA differs"):
        bench.bench_suffix_sort(text)

"""The port's synthetic genome and query batch
(``kiss_tpu_torch/utils/synth.py``) against the originals in ``bench.py``,
element for element, and the smoke script's independence of ``bench.py``.
``bench.py`` imports numpy alone at module level, so importing it here
starts no JAX work."""

import ast
import os

import numpy as np
import pytest

import bench
from kiss_tpu_torch.utils import synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", [1, 1000, 200_003])
def test_synth_genome_equals_bench(n, seed):
    got = synth.synth_genome(n, seed=seed)
    want = bench.synth_genome(n, seed=seed)
    assert got.dtype == want.dtype == np.int8 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


def test_synth_genome_default_seed_equals_bench():
    np.testing.assert_array_equal(synth.synth_genome(5000),
                                  bench.synth_genome(5000))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("qlen", [12, 25])
@pytest.mark.parametrize("n", [1000, 200_003])
def test_sample_patterns_equals_bench(n, qlen, seed):
    text = bench.synth_genome(n, seed=seed)
    got = synth.sample_patterns(text, 777, qlen, seed=seed)
    want = bench.sample_patterns(text, 777, qlen, seed=seed)
    assert got.dtype == want.dtype == np.int8 and got.shape == (777, qlen)
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


def test_sample_patterns_default_seed_equals_bench():
    text = bench.synth_genome(3000)
    np.testing.assert_array_equal(synth.sample_patterns(text, 100, 25),
                                  bench.sample_patterns(text, 100, 25))


def _imported_roots(path):
    """Top-level names of every module a source file imports, wherever in
    the file the import stands."""
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_bench_and_no_jax():
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert not roots & {"bench", "jax", "jaxlib", "kiss_tpu"}, roots
    assert {"torch", "numpy", "kiss_tpu_torch"} <= roots


def test_synth_module_imports_numpy_only():
    path = os.path.join(ROOT, "kiss_tpu_torch", "utils", "synth.py")
    assert _imported_roots(path) == {"__future__", "numpy"}

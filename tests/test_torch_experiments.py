"""The port's experiment protocol on the CPU, at a small size:

- ``experiments.run_experiments`` (the k sweep of either strategy and the
  mesh-size sweep): the JAX script's CSV header and rows, each SA equal to
  ``kiss_tpu``'s or the oracle's, the doubling SA equal to the wide SA at
  every k, the mesh SA equal to the single-device one. The sweep's text is
  a tandem-repeat text here (its ``synth_genome`` swapped), so that the
  rank rounds and the tail refinement run at n = 3000, where the synthetic
  genome is random sequence that the seed alone resolves;
- ``experiments.spot_external_anyk`` (the out-of-core sorter at k = 100):
  its rehearsal with all its checks, its SA against ``kiss_tpu``'s
  out-of-core sorter, and the refusal of a k with no raw-tail round;
- ``experiments.micro_roofline``: the packed ``torch.sort`` against K1's
  plain version, and its rehearsal.

Every output is an integer: every comparison is exact (tolerance 0)."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from kiss_tpu.ops import external_sort as jext
from kiss_tpu.ops import suffix_sort as jss
from kiss_tpu_torch.experiments import (
    micro_roofline,
    run_experiments,
    spot_external_anyk,
)
from kiss_tpu_torch.ops import external_sort
from kiss_tpu_torch.ops.radix_sort import radix_sort_words_plain
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.utils.checks import Kept
from tests import oracle

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3000
KS = (2, 16, 100, -1)


def _text(n, seed=0):
    return oracle.repeat_heavy_dna(n, unit=37, seed=seed)


def _sweep(tmp, *args):
    """(CSV rows, what ``run`` returned) of one ``main`` call on the
    tandem-repeat text."""
    out = str(tmp / "out.csv")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run_experiments, "synth_genome", _text)
        with Kept(run_experiments, "run") as kept:
            assert run_experiments.main(
                ["--device", "cpu", "--n", str(N), "--repeats", "1",
                 "--out", out, *args]) == 0
    with open(out, newline="") as f:
        return list(csv.reader(f)), kept.values[0]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    ks = ",".join(map(str, KS))
    return {strategy: _sweep(tmp_path_factory.mktemp(strategy), "--ks", ks,
                             "--strategy", strategy)
            for strategy in ("wide", "doubling")}


@pytest.mark.parametrize("strategy", ["wide", "doubling"])
def test_sweep_csv_is_the_jax_scripts(sweeps, strategy):
    rows, _ = sweeps[strategy]
    with open(os.path.join(ROOT, "experiments", "results_k_sweep.csv")) as f:
        assert rows[0] == next(csv.reader(f))
    assert rows[0] == run_experiments.HEADER
    algo = {"wide": "kiss-tpu-torch", "doubling": "kiss-tpu-torch-doubling"}
    assert [r[0] for r in rows[1:]] == [algo[strategy]] * len(KS)
    assert [int(r[2]) for r in rows[1:]] == list(KS)
    assert all(r[1] == f"synth{N}" and r[3] == "1" and float(r[4]) > 0
               and int(r[5]) > 0 for r in rows[1:])


@pytest.mark.parametrize("strategy", ["wide", "doubling"])
@pytest.mark.parametrize("k", KS)
def test_sweep_sa(sweeps, strategy, k):
    """The SA of each k: ``kiss_tpu``'s at k = 100 and -1, the oracle's at
    the others; the doubling SA is the wide one."""
    sa = sweeps[strategy][1]["runs"][k].sa
    text = _text(N)
    if k in (100, -1):
        want = jss.k_ordered_suffix_array(text, k, strategy=strategy)
    else:
        want = oracle.k_ordered_sa(text, k)
    np.testing.assert_array_equal(sa, want)
    np.testing.assert_array_equal(sa, sweeps["wide"][1]["runs"][k].sa)


def test_sweep_runs_the_rounds_and_the_tail(sweeps):
    """The text makes the doubling plan run its rounds and the tail
    refinement, and the stage log shows it."""
    runs = sweeps["doubling"][1]["runs"]
    assert any(s.startswith("wide_round[2]") for s in runs[100].stages)
    assert any(s.startswith("tail_refine") for s in runs[-1].stages)


def test_mesh_sweep_equals_single_device(tmp_path):
    rows, result = _sweep(tmp_path, "--devices", "1,2")
    assert [(r[2], r[3]) for r in rows[1:]] == [("256", "1"), ("256", "2")]
    want = k_ordered_suffix_array(_text(N), 256, device="cpu")
    for d in (1, 2):
        np.testing.assert_array_equal(result["runs"][d].sa, want)


def test_spot_external_anyk_rehearsal(tmp_path, capsys):
    results = tmp_path / "r.md"
    assert spot_external_anyk.main(
        ["--device", "cpu", "--n", "200000", "--k", "100", "--pairs",
         "20000", "--results", str(results)]) == 0
    out = capsys.readouterr().out
    assert "[spot] ALL CHECKS PASSED" in out
    report = json.loads(out.strip().splitlines()[-1])
    assert report["n"] == 200_000 and report["tail_chars"] == [36]
    assert "| check: SA is a permutation |" in results.read_text()


def test_spot_external_anyk_equals_kiss_tpu(tmp_path, monkeypatch, capsys):
    """At n = 20,000 on a tandem-repeat text, where the raw-tail round has
    rows to sort: the SA equals ``kiss_tpu``'s out-of-core sorter's."""
    monkeypatch.setattr(spot_external_anyk, "synth_genome", _text)
    with Kept(external_sort, "external_k_ordered_suffix_array") as kept:
        assert spot_external_anyk.main(
            ["--device", "cpu", "--n", "20000", "--k", "100", "--pairs",
             "5000", "--results", str(tmp_path / "r.md")]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["split_s"]["round segments"] > 0
    want = jext.external_k_ordered_suffix_array(_text(20_000), 100)
    np.testing.assert_array_equal(kept.values[0], want)


def test_spot_external_anyk_refuses_a_k_without_a_tail_round(tmp_path):
    with pytest.raises(SystemExit, match="no raw-tail round"):
        spot_external_anyk.main(["--device", "cpu", "--n", "20000", "--k",
                                 "128", "--results", str(tmp_path / "r.md")])


@pytest.mark.parametrize("w", [1, 2])
def test_packed_sort_equals_k1(w):
    """Keys with the top bit set and long runs of ties."""
    rng = np.random.default_rng(w)
    values = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1],
                      dtype=np.uint64)
    keys = torch.from_numpy(rng.choice(values, (w, 5000)).astype(
        np.uint32).view(np.int32))
    got = micro_roofline.packed_sort(keys)
    want = radix_sort_words_plain(keys)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_micro_roofline_rehearsal(tmp_path, capsys):
    results = tmp_path / "roof.md"
    assert micro_roofline.main(
        ["--device", "cpu", "--n", "5000", "--stream-bytes", str(1 << 20),
         "--results", str(results)]) == 0
    text = results.read_text()
    for w in micro_roofline.WIDTHS:
        assert f"| K1 W={w} N=5000 " in text
    assert "torch.sort(stable=True)" in text

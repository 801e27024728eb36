"""The slice as a whole: ``kiss_tpu_torch.cli.main(... --device cpu)``
against ``kiss_tpu.cli.main`` on one FASTA -- equal log lines (timings
masked), equal ``.fmi`` bytes and ``.meta`` sidecars -- plus the port's
device rule and the commands and flags that are not yet ported."""

import json
import logging
import os
import re
import shutil
import struct

import numpy as np
import pytest
import torch

from kiss_tpu import cli as jcli
from kiss_tpu_torch import cli as tcli
from kiss_tpu_torch.utils import codec, fasta
from tests import oracle

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same FASTA in two directories (each CLI writes <fa>.fmi)."""
    root = tmp_path_factory.mktemp("torch_cli")
    text = oracle.repeat_heavy_dna(20_000, unit=900, seed=99)
    jdir, tdir = root / "jax", root / "torch"
    jdir.mkdir()
    tdir.mkdir()
    fasta.write_fasta(jdir / "ref.fa", [fasta.FastaRecord("chr1", text)])
    shutil.copy(jdir / "ref.fa", tdir / "ref.fa")
    rng = np.random.default_rng(1)
    qlen, nq = 11, 300
    pats = [codec.to_string(text[p : p + qlen])
            for p in rng.integers(0, len(text) - qlen, nq - 30)]
    pats += [codec.to_string(rng.integers(0, 4, qlen)) for _ in range(30)]
    bpath = root / "patterns.bin"
    with open(bpath, "wb") as f:
        f.write(struct.pack("<II", qlen, nq))
        f.write("".join(pats).encode())
    return str(jdir / "ref.fa"), str(tdir / "ref.fa"), str(bpath), text


def _lines(main, logger, argv, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        assert main(argv) == 0
    return [
        re.sub(r"\d+\.\d+", "<t>", r.getMessage())
        for r in caplog.records if r.name == logger
    ]


def _both(corpus, caplog, argv):
    jfa, tfa, _, _ = corpus
    want = _lines(jcli.main, "kiss_tpu", argv + [jfa], caplog)
    got = _lines(tcli.main, "kiss_tpu_torch",
                 argv + ["--device", "cpu", tfa], caplog)
    assert got == want
    return got


def _archives_equal(corpus):
    jfa, tfa, _, _ = corpus
    with open(jfa + ".fmi", "rb") as a, open(tfa + ".fmi", "rb") as b:
        assert a.read() == b.read()
    with open(jfa + ".fmi.meta") as a, open(tfa + ".fmi.meta") as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("lookup", ["0", "3"])
def test_slice_matches_kiss_tpu(corpus, caplog, lookup):
    jfa, tfa, bpath, text = corpus
    lines = _both(corpus, caplog, ["suffix_sort", "-k", "64"])
    assert lines == ["n = 20000, k = 64, suffix sorting elapsed <t>"]
    _both(corpus, caplog, ["suffix_sort", "-s", "prefix_doubling", "-k",
                           "-1"])
    _both(corpus, caplog, ["fmindex_build", "-l", lookup])
    _archives_equal(corpus)
    lines = _both(corpus, caplog, ["fmindex_query", "-q",
                                   codec.to_string(text[500:520]), "-n",
                                   "3"])
    assert "found" in lines[0]
    lines = _both(corpus, caplog, ["fmindex_query", "-b", bpath])
    assert lines[0] == "query_len: 11, num_query: 300"
    assert lines[2].startswith("number of matched locations: ")


def test_num_threads_clamps_to_one_device(corpus, caplog):
    _both(corpus, caplog, ["suffix_sort", "-k", "100", "-t", "4"])


def test_cuda_without_cuda_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without")
    _, tfa, _, _ = corpus
    for argv in (["suffix_sort", tfa], ["fmindex_build", tfa],
                 ["fmindex_query", "-q", "ACGT", tfa]):
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(argv)  # --device defaults to cuda


def test_not_yet_ported_raise(corpus, monkeypatch):
    _, tfa, _, _ = corpus
    cpu = ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match="LMS_INDUCED"):
        tcli.main(["suffix_sort", "-s", "lms_induced", *cpu, tfa])
    with pytest.raises(NotImplementedError, match="external"):
        tcli.main(["suffix_sort", "--external", *cpu, tfa])
    with pytest.raises(NotImplementedError, match="serve"):
        tcli.main(["serve", *cpu, tfa])
    monkeypatch.setattr(tcli, "in_core_capacity_chars", lambda device: 1000)
    with pytest.raises(NotImplementedError, match="in-core device budget"):
        tcli.main(["suffix_sort", *cpu, tfa])
    with pytest.raises(SystemExit):
        tcli.main(["suffix_sort", "-g", *cpu, tfa])


def test_in_core_capacity(monkeypatch):
    assert (tcli.in_core_capacity_chars("cpu")
            == tcli.EXTERNAL_THRESHOLD_FALLBACK)
    monkeypatch.setenv("KISS_TPU_INCORE_CAP", "1234")
    assert tcli.in_core_capacity_chars("cuda") == 1234


def test_sidecar_routes_locate(tmp_path, caplog):
    """Without a valid full_sa sidecar the locate goes through the range
    BFS, with one, or with --assume-full-sa, through the per-row walk:
    the log lines, occurrences and checksum are kiss_tpu.cli's either
    way, for a stale sidecar, a lost one and a ``-k 32`` build."""
    text = oracle.repeat_heavy_dna(3_000, unit=45, seed=4)
    jfa, fa = str(tmp_path / "j.fa"), str(tmp_path / "s.fa")
    fasta.write_fasta(fa, [fasta.FastaRecord("s", text)])
    shutil.copy(fa, jfa)
    rng = np.random.default_rng(2)
    qlen, nq = 12, 120
    pats = [codec.to_string(text[p : p + qlen])
            for p in rng.integers(0, len(text) - qlen, nq)]
    bpath = str(tmp_path / "patterns.bin")
    with open(bpath, "wb") as f:
        f.write(struct.pack("<II", qlen, nq))
        f.write("".join(pats).encode())
    pat = pats[0]
    hits = oracle.search_all(text, codec.to_istring(pat))

    def both(argv):
        want = _lines(jcli.main, "kiss_tpu", argv + [jfa], caplog)
        got = _lines(tcli.main, "kiss_tpu_torch",
                     argv + ["--device", "cpu", fa], caplog)
        assert got == want
        return got

    def queries_agree():
        lines = both(["fmindex_query", "-q", pat, "-n", "1000"])
        assert lines[0] == f"query = {pat} found {len(hits)} times"
        shown = sorted(int(m.split(" position is ")[1].split(",")[0])
                       for m in lines[1:])
        assert shown == hits.tolist()
        lines = both(["fmindex_query", "-b", bpath])
        assert lines[2].startswith("number of matched locations: ")
        assert lines[3].startswith("location checksum: ")
        return lines[2:]

    both(["fmindex_build"])
    full = queries_agree()  # valid sidecar: the per-row walk
    for path in (jfa, fa):  # content change -> stale sidecar -> BFS
        with open(path + ".fmi", "r+b") as f:
            f.seek(30)
            byte = f.read(1)
            f.seek(30)
            f.write(bytes([byte[0] ^ 1]))
    assert tcli.main(["fmindex_query", "-q", pat, "--device", "cpu", fa]) == 0
    both(["fmindex_build"])
    for path in (jfa, fa):  # sidecar lost -> BFS, same answers
        os.unlink(path + ".fmi.meta")
    assert queries_agree() == full
    lines = _lines(tcli.main, "kiss_tpu_torch",
                   ["fmindex_query", "--assume-full-sa", "-q", pat,
                    "--device", "cpu", fa], caplog)
    assert lines[0] == f"query = {pat} found {len(hits)} times"
    both(["fmindex_build", "-k", "32"])  # 32 >= sa_intv - 1 + qlen: exact
    with open(fa + ".fmi.meta") as f:
        assert json.load(f)["full_sa"] is False
    assert queries_agree() == full


def test_verbose_stage_log_and_version(tmp_path, caplog, capsys):
    unit = oracle.random_dna(13, seed=3)
    text = np.tile(unit, 2000)[:20_000]
    fa = str(tmp_path / "rep.fa")
    fasta.write_fasta(fa, [fasta.FastaRecord("chr1", text)])
    with caplog.at_level(logging.DEBUG, logger="kiss_tpu_torch"):
        assert tcli.main(["suffix_sort", "-k", "256", "--verbose",
                          "--device", "cpu", fa]) == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("seed_sort(chars=64) elapsed ") for m in msgs)
    assert any(m.startswith("wide_round[0]") for m in msgs)
    assert tcli.main(["-v"]) == 0
    assert capsys.readouterr().out.strip() == tcli.VERSION

"""The slice as a whole: ``kiss_tpu_torch.cli.main(... --device cpu)``
against ``kiss_tpu.cli.main`` on one FASTA -- equal log lines (timings
masked), equal ``.fmi`` bytes and ``.meta`` sidecars -- the sort routes
(``--external``, the automatic out-of-core route, ``-s LMS_INDUCED``),
``serve``, ``-t N`` over a mesh of CPU shards, the port's device rule and
what the reference rejects."""

import io
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
from kiss_tpu_torch.ops import external_sort as ext
from kiss_tpu_torch.ops import suffix_sort as tss
from kiss_tpu_torch.utils import codec, fasta
from kiss_tpu_torch.utils.checks import Kept
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


def test_negative_probes_match_kiss_tpu(corpus, caplog, capsys):
    """The negative probes of ``experiments/cli_e2e_tpu.py``: an absent
    pattern is found 0 times, and a k that is not a number is refused by
    both CLIs."""
    _both(corpus, caplog, ["fmindex_build"])
    lines = _both(corpus, caplog, ["fmindex_query", "-q", "C" * 22])
    assert lines[0].endswith("found 0 times")
    jfa, tfa, _, _ = corpus
    for main, fa in ((jcli.main, jfa), (tcli.main, tfa)):
        with pytest.raises(SystemExit):
            main(["suffix_sort", "-k", "zzz", "--device", "cpu", fa]
                 if main is tcli.main else ["suffix_sort", "-k", "zzz", fa])
        assert "invalid int" in capsys.readouterr().err


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
    """``--generic`` is rejected on every command, as by the reference.
    (``-t N`` over several devices no longer raises: the ``-t 2`` and
    ``-t 4`` tests below hold it against ``kiss_tpu``.) The
    out-of-core route ignores ``-t``, as in kiss_tpu, also with two
    devices made visible to the planner."""
    _, tfa, _, _ = corpus
    cpu = ["--device", "cpu"]
    for cmd in ("suffix_sort", "fmindex_build", "fmindex_query", "serve"):
        with pytest.raises(SystemExit):
            tcli.main([cmd, "-g", *cpu, tfa])
    monkeypatch.setattr(tss, "_mesh_size_for", lambda num_threads, device: 2)
    assert tcli.main(["suffix_sort", "--external", "-t", "2", *cpu, tfa]) == 0


@pytest.mark.parametrize("argv,cap", [
    (["suffix_sort", "--external", "-k", "256"], None),
    (["suffix_sort", "--external", "-k", "100", "-s", "prefix_doubling"],
     None),
    (["suffix_sort", "-k", "256"], "5000"),  # over capacity: routed
    (["suffix_sort", "-k", "-1"], "20000"),  # n == capacity: routed
])
def test_external_routes_match_kiss_tpu(corpus, caplog, monkeypatch, argv,
                                         cap):
    """``--external`` and the automatic route (KISS_TPU_INCORE_CAP at or
    under n) give kiss_tpu.cli's log lines, the ``routing:`` line
    included, and the SA the port's out-of-core sorter returns is the
    in-core one."""
    import kiss_tpu.ops.external_sort as jext

    if cap:
        monkeypatch.setenv("KISS_TPU_INCORE_CAP", cap)
    with Kept(jext, "external_k_ordered_suffix_array") as jkept, \
            Kept(ext, "external_k_ordered_suffix_array") as tkept:
        lines = _both(corpus, caplog, argv)
    jkept, tkept = jkept.values, tkept.values
    assert (lines[0].startswith("routing: n = 20000 exceeds the in-core "
                                f"device budget ({cap} chars x 1 device(s))")
            == bool(cap))
    assert len(jkept) == len(tkept) == 1
    k = int(argv[argv.index("-k") + 1])
    np.testing.assert_array_equal(tkept[0], jkept[0])
    np.testing.assert_array_equal(
        tkept[0], tss.k_ordered_suffix_array(corpus[3], k, device="cpu")
    )


def test_lms_never_autoroutes(corpus, caplog, monkeypatch):
    """Host-resident ``-s LMS_INDUCED`` under a capacity far below n: no
    out-of-core route, the log lines of kiss_tpu.cli, ``-t`` as threads
    (no device count check)."""
    monkeypatch.setenv("KISS_TPU_INCORE_CAP", "10")

    def boom(*args, **kwargs):
        raise AssertionError("LMS_INDUCED was routed out-of-core")

    monkeypatch.setattr(ext, "external_k_ordered_suffix_array", boom)
    monkeypatch.setattr(tss, "_mesh_size_for", lambda num_threads, device: 2)
    lines = _both(corpus, caplog,
                  ["suffix_sort", "-s", "lms_induced", "-k", "16", "-t", "2"])
    assert lines == ["n = 20000, k = 16, suffix sorting elapsed <t>"]


def test_serve_matches_kiss_tpu(corpus, caplog, tmp_path):
    """``serve`` with an injected stdin: a pattern, ``batch <file>``, a
    missing batch file and ``quit`` answer ``ready`` / ``ok`` / ``ok`` /
    ``err ...`` and stop, with kiss_tpu.cli.serve_main's log lines."""
    jfa, tfa, bpath, text = corpus
    _both(corpus, caplog, ["fmindex_build"])
    pattern = codec.to_string(text[700:716])
    requests = (f"{pattern}\nbatch {bpath}\n"
                f"batch {tmp_path / 'missing.bin'}\nquit\nACGT\n")

    def serve(mod, logger, argv):
        args = mod.build_parser().parse_args(["serve", *argv])
        out = io.StringIO()
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger):
            mod.serve_main(args, io.StringIO(requests), out)
        logs = [re.sub(r"\d+\.\d+", "<t>", r.getMessage())
                for r in caplog.records if r.name == logger]
        return re.sub(r"\d+\.\d+", "<t>", out.getvalue()).splitlines(), logs

    want = serve(jcli, "kiss_tpu", ["--warm", "12", "-n", "4", jfa])
    got = serve(tcli, "kiss_tpu_torch",
                ["--warm", "12", "-n", "4", "--device", "cpu", tfa])
    assert got == want
    out, logs = got
    assert out[:3] == ["ready", "ok <t>", "ok <t>"]
    assert out[3].startswith("err FileNotFoundError: ") and len(out) == 4
    hits = oracle.search_all(text, codec.to_istring(pattern))
    assert logs[0] == f"query = {pattern} found {len(hits)} times"


def test_in_core_capacity(monkeypatch):
    assert (tcli.in_core_capacity_chars("cpu")
            == tcli.EXTERNAL_THRESHOLD_FALLBACK)
    monkeypatch.setenv("KISS_TPU_INCORE_CAP", "1234")
    assert tcli.in_core_capacity_chars("cuda") == 1234
    # a mesh holds 1/D of every length-N array a card: D cards' capacity
    assert tcli.in_core_capacity_chars("cuda", 4) == 4 * 1234
    monkeypatch.delenv("KISS_TPU_INCORE_CAP")
    total = 80 * 10**9
    monkeypatch.setattr(tcli.torch.cuda, "mem_get_info",
                        lambda dev: (total // 2, total))
    usable = int(total * tcli.IN_CORE_MEM_FRACTION)
    assert (tcli.in_core_capacity_chars("cuda")
            == usable // tcli.IN_CORE_BYTES_PER_CHAR)
    # a mesh's card holds its blocks at the measured cost of the algorithm
    # -t N sorts with (bitonic on two cards, columnsort on more)
    for d, algo in ((2, "bitonic"), (4, "columnsort"), (8, "columnsort")):
        assert (tcli.in_core_capacity_chars("cuda", d)
                == d * (usable // tcli.MESH_BLOCK_BYTES_PER_CHAR[algo]))


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


@pytest.fixture(scope="module")
def mesh_corpus(tmp_path_factory):
    """A repeat-heavy FASTA in three directories -- kiss_tpu ``-t N``, the
    port's ``-t N`` and the port's ``-t 1`` -- and a batch file."""
    root = tmp_path_factory.mktemp("torch_cli_mesh")
    text = oracle.repeat_heavy_dna(6_000, unit=450, seed=7)
    paths = []
    for name in ("jax", "torch", "torch1"):
        (root / name).mkdir()
        paths.append(str(root / name / "ref.fa"))
        fasta.write_fasta(paths[-1], [fasta.FastaRecord("chr1", text)])
    assert tcli.main(["fmindex_build", "--device", "cpu", paths[2]]) == 0
    rng = np.random.default_rng(5)
    qlen, nq = 12, 150
    pats = [codec.to_string(text[p : p + qlen])
            for p in rng.integers(0, len(text) - qlen, nq - 20)]
    pats += [codec.to_string(rng.integers(0, 4, qlen)) for _ in range(20)]
    bpath = str(root / "patterns.bin")
    with open(bpath, "wb") as f:
        f.write(struct.pack("<II", qlen, nq))
        f.write("".join(pats).encode())
    return (*paths, bpath, text)


def _verbose_lines(main, logger, argv, caplog):
    caplog.clear()
    with caplog.at_level(logging.DEBUG, logger=logger):
        assert main(argv) == 0
    return [
        re.sub(r"\d+\.\d+", "<t>", r.getMessage())
        for r in caplog.records if r.name == logger
    ]


@pytest.mark.parametrize("d", [2, 4])
def test_num_threads_mesh_matches_kiss_tpu(mesh_corpus, caplog, monkeypatch,
                                           d):
    """``-t d`` on every command, with ``d`` CPU shards made visible to the
    port's planner (kiss_tpu runs its ``d``-device virtual mesh): the
    ``--verbose`` log lines of kiss_tpu.cli (the sharded-build and
    sharded-query lines and stages included), the SAs of both mesh
    sorters equal each other and the port's ``-t 1`` SA, and the ``.fmi``
    bytes equal kiss_tpu's ``-t d`` archive and the port's ``-t 1``
    archive; ``-q``, ``-b`` and ``serve`` through the row-sharded index
    give kiss_tpu's lines, counts and checksum."""
    import kiss_tpu.parallel.dsort as jdsort

    from kiss_tpu_torch.parallel import sharded_plan

    jfa, tfa, t1fa, bpath, text = mesh_corpus
    monkeypatch.setattr(tss, "_mesh_size_for",
                        lambda num_threads, device: max(num_threads, 1))

    def both(argv):
        flags = ["-t", str(d), "--verbose"]
        want = _verbose_lines(jcli.main, "kiss_tpu", argv + flags + [jfa],
                              caplog)
        got = _verbose_lines(tcli.main, "kiss_tpu_torch",
                             argv + flags + ["--device", "cpu", tfa], caplog)
        assert got == want
        return got

    for argv, k in ((["suffix_sort", "-k", "64"], 64),
                    (["suffix_sort", "-s", "prefix_doubling", "-k", "-1"], -1),
                    (["fmindex_build"], -1)):
        with Kept(jdsort, "sharded_k_ordered_suffix_array") as jkept, \
                Kept(sharded_plan, "sharded_sa_blocks") as tkept:
            lines = both(argv)
        (jsa,), (blocks,) = jkept.values, tkept.values
        assert len(blocks) == d  # the SA leaves the mesh as its blocks
        tsa = torch.cat(blocks)[: len(text) + 1]
        np.testing.assert_array_equal(tsa.numpy(), np.asarray(jsa))
        np.testing.assert_array_equal(
            tsa.numpy(), tss.k_ordered_suffix_array(text, k, device="cpu"))
    assert lines == [f"fmindex_build: sharded build over {d} devices",
                     "suffix sort (sharded) elapsed <t>",
                     "fmindex build (sharded) elapsed <t>"]
    with open(jfa + ".fmi", "rb") as a, open(tfa + ".fmi", "rb") as b, \
            open(t1fa + ".fmi", "rb") as c:
        got = b.read()
        assert got == a.read() and got == c.read()
    pattern = codec.to_string(text[1000:1012])
    lines = both(["fmindex_query", "-q", pattern, "-n", "5"])
    assert lines[0] == f"fmindex_query: index sharded over {d} devices"
    hits = oracle.search_all(text, codec.to_istring(pattern))
    assert lines[1] == f"query = {pattern} found {len(hits)} times"
    lines = both(["fmindex_query", "-b", bpath])
    assert lines[4].startswith("number of matched locations: ")
    single = _lines(tcli.main, "kiss_tpu_torch",
                    ["fmindex_query", "-b", bpath, "--device", "cpu", t1fa],
                    caplog)
    assert single[2:] == lines[4:6]

    def serve(mod, logger, fa, extra):
        args = mod.build_parser().parse_args(
            ["serve", "-t", str(d), "--warm", "8", *extra, fa])
        out = io.StringIO()
        mod.serve_main(args, io.StringIO(f"{pattern}\nbatch {bpath}\n"), out)
        return re.sub(r"\d+\.\d+", "<t>", out.getvalue()).splitlines()

    assert (serve(tcli, "kiss_tpu_torch", tfa, ["--device", "cpu"])
            == serve(jcli, "kiss_tpu", jfa, [])
            == ["ready", "ok <t>", "ok <t>"])


@pytest.mark.parametrize("d", [2, 4])
def test_num_threads_mesh_bounded_archive(mesh_corpus, caplog, monkeypatch,
                                          d, tmp_path):
    """``fmindex_build -k 32 -t d`` writes kiss_tpu's archive, and ``-q`` /
    ``-b`` on it over the mesh take the range BFS on the lead device
    (kiss_tpu's debug line says so) with kiss_tpu's answers."""
    jfa, _, _, bpath, text = mesh_corpus
    fa = str(tmp_path / "k32.fa")
    jk = str(tmp_path / "jk32.fa")
    shutil.copy(jfa, fa)
    shutil.copy(jfa, jk)
    monkeypatch.setattr(tss, "_mesh_size_for",
                        lambda num_threads, device: max(num_threads, 1))
    for argv in (["fmindex_build", "-k", "32"],
                 ["fmindex_query", "-q", codec.to_string(text[40:52])],
                 ["fmindex_query", "-b", bpath]):
        flags = ["-t", str(d), "--verbose"]
        want = _verbose_lines(jcli.main, "kiss_tpu", argv + flags + [jk],
                              caplog)
        got = _verbose_lines(tcli.main, "kiss_tpu_torch",
                             argv + flags + ["--device", "cpu", fa], caplog)
        assert got == want
        if "-q" in argv:
            assert any("range-BFS locate" in m for m in got)
    with open(jk + ".fmi", "rb") as a, open(fa + ".fmi", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_keeps_single_device_capacity(mesh_corpus, caplog, monkeypatch,
                                           d):
    """Each card of a mesh keeps the single-device capacity, so ``-t d``
    multiplies it by d, as kiss_tpu.cli does: with one card's capacity
    between n / d and n the text stays in core (the mesh's SA), and under
    n / d ``-t d`` routes out of core with kiss_tpu.cli's ``routing:``
    line (one card's capacity x d devices), its SA the in-core one."""
    jfa, tfa, _, _, text = mesh_corpus
    monkeypatch.setattr(tss, "_mesh_size_for",
                        lambda num_threads, device: max(num_threads, 1))
    argv = ["suffix_sort", "-k", "100", "-t", str(d)]
    monkeypatch.setenv("KISS_TPU_INCORE_CAP", str(len(text) * 3 // 4))
    with Kept(ext, "external_k_ordered_suffix_array") as kept:
        lines = _lines(tcli.main, "kiss_tpu_torch",
                       argv + ["--device", "cpu", tfa], caplog)
    assert kept.values == [] and not lines[0].startswith("routing: ")
    cap = len(text) // d - 1
    monkeypatch.setenv("KISS_TPU_INCORE_CAP", str(cap))
    want = _lines(jcli.main, "kiss_tpu", argv + [jfa], caplog)
    with Kept(ext, "external_k_ordered_suffix_array") as kept:
        lines = _lines(tcli.main, "kiss_tpu_torch",
                       argv + ["--device", "cpu", tfa], caplog)
    assert lines == want
    assert lines[0].startswith(
        f"routing: n = {len(text)} exceeds the in-core device budget "
        f"({cap} chars x {d} device(s))")
    np.testing.assert_array_equal(
        kept.values[0], tss.k_ordered_suffix_array(text, 100, device="cpu"))

"""kiss_tpu_torch.experiments.fm_query_time on the CPU: the 32-byte sector
counts it reports for K2 and K3, held against a scalar replay of every
query and row, step by step; and its main at a small size (the plain
versions, the host's clock)."""

import torch

from kiss_tpu_torch.experiments import fm_query_time as fqt
from kiss_tpu_torch.models import fm_index as fm
from tests import oracle

torch.set_num_threads(1)


def _index_and_queries():
    text = oracle.repeat_heavy_dna(6000, unit=300, seed=4)
    fmi = fm.FMIndex(sa_intv=4, device="cpu").build(text)
    qw, q_rows, rand_rows = fqt.query_inputs(fmi, text, 120, "cpu")
    return fmi, qw, rand_rows


def _lf(a, c, i):
    return int(fm._lf(a, torch.tensor([c]), torch.tensor([i]))[0])


def test_k2_sectors_match_a_scalar_replay():
    fmi, qw, _ = _index_and_queries()
    a = fmi.arrays
    want_steps = want_old = want_new = 0
    for q in range(qw.shape[0]):
        w = int(qw[q, 0]) & 0xFFFFFFFF, int(qw[q, 1]) & 0xFFFFFFFF
        b, e = 0, int(a.lookup[-1])
        for j in range(fqt.QLEN - 1, -1, -1):
            if e <= b:
                break
            c = (w[j // 16] >> (2 * (j % 16))) & 3
            # lf_tab: words 5 (x >> 4) + c and 5 (x >> 4) + 4 of each bound
            want_old += len({(20 * (x >> 4) + off) >> 5
                             for x in (b, e) for off in (4 * c, 16)})
            want_new += len({b >> 6, e >> 6})
            want_steps += 1
            b, e = _lf(a, c, b), _lf(a, c, e)
    assert fqt.k2_sectors(a, qw, fqt.QLEN) == (want_steps, want_old,
                                               want_new)


def test_walk_sectors_match_a_scalar_replay():
    fmi, _, rows = _index_and_queries()
    a = fmi.arrays
    want_steps = want_old = want_new = 0
    samples = []
    for i in rows.tolist():
        for k in range(4):
            last = bool(fm._b_at(a, torch.tensor([i]))[0]) or k == 3
            if last:  # b_tab's 12-byte row for the rank
                want_old += len({(12 * (i >> 6) + off) >> 5
                                 for off in (0, 4, 8)})
            else:  # the mark word, then lf_tab's BWT word and one count
                c = int(fm._bwt_at(a, torch.tensor([i]))[0])
                want_old += 1 + len({(20 * (i >> 4) + 16) >> 5,
                                     (20 * (i >> 4) + 4 * c) >> 5})
            want_new += 1
            if last:
                break
            want_steps += 1
            i = _lf(a, c, i)
        want_old += 1  # sa_samp
        want_new += 1
        samples.append(int(fm._b_rank(a, torch.tensor([i]))[0]))
    assert fqt.walk_sectors(a, rows, 4) == (want_steps, want_old, want_new)
    assert fqt.sample_index(a, rows, 4).tolist() == samples


def test_main_rehearses_on_the_cpu(capsys):
    assert fqt.main(["--device", "cpu", "--n", "20000", "--queries", "400",
                     "--chunk", "100", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    for what in ("K2 chunk 100", "K2 batch 400", "K3 stats chunk 100",
                 "as the CLI calls it", "K3 rows -q rows",
                 "K3 rows random rows 400", "K4 fm_bfs_stats chunk 100",
                 "K4 fm_bfs_locate chunk 100", "K4 fm_bfs_stats batch 400",
                 "K4 fm_bfs_locate batch 400", "G/s; K2 131 G sectors/s",
                 "queries on the spill route"):
        assert what in out, what


def test_bfs_work_matches_the_kernels_walk():
    """The nodes, entries, LF steps, segments and positions that K4's bound
    counts are those of the kernel's level-by-level walk (the CPU model of
    test_torch_bfs_kernel, its spill route included)."""
    from tests.test_torch_bfs_kernel import Model

    text = oracle.repeat_heavy_dna(3000, unit=40, seed=5)
    fmi = fm.FMIndex(sa_intv=4, device="cpu").build(text, sort_len=32)
    qw, _, _ = fqt.query_inputs(fmi, text, 60, "cpu")
    beg, end, _ = fm.get_range_packed_device_plain(fmi.arrays, qw, fqt.QLEN,
                                                   0)
    model = Model(fmi)
    pri = int(fmi.arrays.pri)
    count = dict(nodes=0, entries=0, lfs=0, segments=0, positions=0)

    def visit(s, j, d, mb, me):
        nb, ne = int(s["x"][j]), int(s["y"][j])  # the node's rows
        one = ne - nb == 1
        count["nodes"] += 1
        count["entries"] += 1 if one else 2
        if d < 3:
            count["lfs"] += (nb != pri) if one else 8
        count["segments"] += me > mb
        count["positions"] += me - mb

    report = [0, 0, 0, 0]
    b, e = beg.numpy(), end.numpy()
    for t0 in model.tiles(len(b)):
        for stores in model.warps(b, e, t0, 1 << 20, report):
            model.walk(stores, visit)
    assert report[2] > 0  # some of the walk on the spill route
    assert fqt.bfs_work(fmi.arrays, beg, end, 4) == tuple(count.values())
    assert count["positions"] == int((end - beg).sum())
    assert count["entries"] < 2 * count["nodes"]


def test_parse_ptxas():
    """The registers, stack frame and spills of each kernel, from nvcc
    -Xptxas -v output (mangled names shortened after demangling)."""
    text = (
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kv\n"
        "    384 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 48 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1jv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 16 registers\n"
    )
    assert fqt.parse_ptxas(text) == [("_Z1kv", 48, 384, 8, 4),
                                     ("_Z1jv", 16, 0, 0, 0)]
    names = {"_Z1kv": "void <unnamed>::walk_kernel<(int)8>(Tables)",
             "_Z1jv": "(anonymous namespace)::expand(long long)"}
    assert [r[0] for r in fqt.parse_ptxas(
        text, lambda ns: [names[n] for n in ns])] == ["walk_kernel<8>",
                                                      "expand"]

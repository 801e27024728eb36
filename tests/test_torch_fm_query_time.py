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
                 "K4 fm_bfs_locate batch 400"):
        assert what in out, what


def test_bfs_work_matches_the_kernels_walk():
    """The nodes, segments and positions that K4's bound counts are those
    of the kernel's pruned walk (the CPU model of test_torch_bfs_kernel)."""
    from tests.test_torch_bfs_kernel import Model

    text = oracle.repeat_heavy_dna(3000, unit=40, seed=5)
    fmi = fm.FMIndex(sa_intv=4, device="cpu").build(text, sort_len=32)
    qw, _, _ = fqt.query_inputs(fmi, text, 60, "cpu")
    beg, end, _ = fm.get_range_packed_device_plain(fmi.arrays, qw, fqt.QLEN,
                                                   0)
    model = Model(fmi)
    nodes = entries = lfs = segments = positions = 0
    for b, e in zip(beg.tolist(), end.tolist()):
        stack = [(b, e)] if b < e else []
        # the node ranges in the walk's order, beside what it yields
        for d, mb, me in model.walk(b, e):
            nb, ne = stack.pop()
            one = ne - nb == 1
            nodes += 1
            entries += 1 if one else 2
            if d < 3:
                lfs += (nb != int(fmi.arrays.pri)) if one else 8
                kids = [tuple(int(fm._lf(fmi.arrays, torch.tensor([c]),
                                         torch.tensor([x]))[0])
                              for x in (nb, ne))
                        for c in range(4)]
                stack += [k for k in reversed(kids) if k[0] < k[1]]
            segments += me > mb
            positions += me - mb
    assert fqt.bfs_work(fmi.arrays, beg, end, 4) == (
        nodes, entries, lfs, segments, positions)
    assert positions == int((end - beg).sum()) and entries < 2 * nodes

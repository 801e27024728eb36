"""The program's spans and counters on the card, through the readers that
read them: one traced operation of each kind (a sort, a build, a batch by
the per-row walk and one by the range BFS) at a small size, each under
``torch.profiler`` as a traced window is. No event on the device's
timeline is a span; K1's counters count; every reader of the spans gives
a number, the K1 rooflines under 100%. Marked ``cuda``; each test skips
where no card is found (decided inside the test). On the card:

    python -m pytest --noconftest -m cuda kissbench/tests/test_kissbench_spans_card.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from kissbench.tests import helpers

pytestmark = pytest.mark.cuda

N = 2_400_000
READERS = {
    "sort": ("k1_roofline.sort", "rounds_device_ms.sort"),
    "build": ("k1_roofline.build", "tables_device_ms.build"),
    "walk": ("host_ms.query",),
    "bfs": ("host_ms.query",),
}


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _traced(op):
    """(the profiler's events, the reduced trace, the program's span
    summary, {reader: value}) of one ``op()`` traced as a window is."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from kiss_tpu_torch import kernels
    from kiss_tpu_torch.utils import timing
    from kissbench import trace

    timing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_MARK):
            with record_function(trace.OP_MARK):
                op()
                torch.cuda.synchronize()
    events = prof.events()
    s = trace.summarize(events, trace.hand_kernels(kernels.CSRC), 1)
    return events, s, timing.span_summary()


def _read(kind, s):
    from kissbench.run import load_file

    return {
        name: load_file(os.path.join(helpers.REPO, "kissbench", "metrics",
                                     name + ".py"),
                        "m_" + name.replace(".", "_")).read(s, {})
        for name in READERS[kind]
    }


@pytest.fixture(scope="module")
def traced():
    """Each kind's traced operation, after one warm call of it."""
    _need_card()
    import torch

    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.ops import suffix_sort
    from kiss_tpu_torch.utils import timing
    from kissbench.synth import pack_queries_2bit, sample_patterns, \
        synth_genome

    dev = torch.device("cuda")
    text = synth_genome(N, 2**33 + 19)
    text_dev = torch.from_numpy(text).to(dev)
    pats = sample_patterns(text, 50_000, 25, seed=2**32 + 3)
    qw = torch.from_numpy(pack_queries_2bit(pats).view(np.int32)).to(dev)
    full = fm.FMIndex(sa_intv=4, device=dev).build(text)
    k32 = fm.FMIndex(sa_intv=4, device=dev).build(text, sort_len=32)

    def batch(index, stats):
        beg, end, _ = fm.get_range_packed_device(index.arrays, qw, 25, 0,
                                                 blocks=index.blocks)
        return stats(index.arrays, beg, end, 4, blocks=index.blocks)

    ops = {
        "sort": lambda: suffix_sort.k_ordered_suffix_array(
            text_dev, 256, as_numpy=False, device=dev),
        "build": lambda: fm.FMIndex(sa_intv=4, device=dev).build(text),
        "walk": lambda: batch(full, fm.batch_locate_stats_device),
        "bfs": lambda: batch(k32, fm.bfs_query_stats),
    }
    out = {}
    for kind, op in ops.items():
        op()  # warm
        events, s, spans = _traced(op)
        out[kind] = (events, spans, _read(kind, s))
    timing.reset_spans()
    return out


@pytest.mark.parametrize("kind", list(READERS))
def test_no_span_on_the_device_timeline(traced, kind):
    from torch.autograd import DeviceType

    events, spans, _ = traced[kind]
    host = {e.name for e in events if e.name.startswith("kiss.")
            and e.device_type == DeviceType.CPU}
    assert host == set(spans)
    assert not [e.name for e in events if e.name.startswith("kiss.")
                and e.device_type != DeviceType.CPU]


@pytest.mark.parametrize("kind", list(READERS))
def test_every_reader_gives_a_number(traced, kind):
    _, _, values = traced[kind]
    for name, value in values.items():
        assert isinstance(value, float) and value > 0, (name, value)
        if name.startswith("k1_roofline"):
            assert value < 100, (name, value)


def test_k1_counts_its_keys(traced):
    _, spans, _ = traced["sort"]
    counts = spans["kiss.sort"]["counts"]
    assert counts["k1_key_words"] > 0
    assert counts["k1_keys"] >= N + 1  # the seed sort's keys, at least
    assert spans["kiss.sort"]["device_ms"] > 0
    _, spans, _ = traced["build"]
    assert spans["kiss.build"]["counts"]["k1_key_words"] > 0


def test_query_spans_wait_inside_the_wrappers(traced):
    for kind, top in (("walk", "kiss.query.locate"),
                      ("bfs", "kiss.query.bfs")):
        _, spans, _ = traced[kind]
        assert {"kiss.query.search", top, "kiss.query.wait"} <= set(spans)
        assert spans["kiss.query.wait"]["device_ms"] is None
        assert spans[top]["self_host_ms"] < spans[top]["host_ms"]

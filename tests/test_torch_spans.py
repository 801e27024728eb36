"""The library's spans (``kiss_tpu_torch.utils.timing.span``) on the CPU:
nothing at all with no profiler and no ``--verbose``; the stopwatch lines
of ``--verbose`` as they were; under ``torch.profiler`` host events named
``kiss.*``, nested as the library's phases are, on the profiler's clock,
with records whose self times and counters add up."""

from __future__ import annotations

import logging
import re

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops import suffix_sort as ss
from kiss_tpu_torch.utils import timing


def _text() -> np.ndarray:
    """40,000 characters: a 4,200-character segment twice, and between and
    after its copies 108 copies of a 280-character unit, each followed by
    10 random characters. 81% of the rows are tied after the 64-character
    seed (the short copies and the long ones), 20% after 512 characters
    (the long copies), 2% after 4,096: the full sort needs a round over the
    whole array, then two tail refinements."""
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 280).astype(np.int8)
    long = rng.integers(0, 4, 4200).astype(np.int8)
    mid = np.concatenate([np.concatenate([unit, rng.integers(0, 4, 10)])
                          for _ in range(108)]).astype(np.int8)
    half = mid.shape[0] // 2
    text = np.concatenate([long, mid[:half], long, mid[half:]])
    return np.concatenate([text, rng.integers(0, 4, 40000 - text.shape[0])
                           .astype(np.int8)])


@pytest.fixture(autouse=True)
def clean():
    timing.reset_spans()
    yield
    timing.reset_spans()


def _query_all(index: fm.FMIndex, text: np.ndarray):
    """K2's route, the per-row walk's and the range BFS's plain routes."""
    pats = np.stack([text[i:i + 12] for i in range(0, 4000, 40)])
    qw = torch.from_numpy(pack.np_pack_queries_2bit(pats).view(np.int32))
    beg, end, _ = fm.get_range_packed_device(index.arrays, qw, 12, 0,
                                             blocks=index.blocks)
    walk = fm.batch_locate_stats_device(index.arrays, beg, end, 4,
                                        blocks=index.blocks)
    bfs = fm.bfs_query_stats(index.arrays, beg, end, 4, blocks=index.blocks)
    return walk, bfs


@pytest.fixture(scope="module")
def traced():
    """One index build and the three query routes under a CPU profiler:
    (profiler, the records, their summary, the answers)."""
    timing.reset_spans()
    text = _text()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index = fm.FMIndex(sa_intv=4, device="cpu").build(text)
        answers = _query_all(index, text)
    recs = list(timing.RECORDS)
    summary = timing.span_summary()
    timing.reset_spans()
    return prof, recs, summary, answers


def test_off_records_nothing():
    """No profiler, no --verbose: every span is the shared do-nothing one,
    and a build and its queries leave no record and no counts."""
    assert timing.span("kiss.sort", device=True) is timing.span("kiss.x")
    assert timing.span(None, log="fmindex build") is timing.span("kiss.y")
    text = _text()
    index = fm.FMIndex(sa_intv=4, device="cpu").build(text)
    off = _query_all(index, text)
    timing.add("k1_keys", 5)
    assert timing.RECORDS == [] and timing.span_summary() == {}
    timing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _query_all(index, text)
    assert on == off  # the spans change no answer
    assert [e.name for e in prof.events() if e.name.startswith("kiss.")]
    assert [r.name for r in timing.RECORDS] == [
        "kiss.query.search", "kiss.query.locate", "kiss.query.bfs"]


def test_verbose_lines_keep_their_text(caplog):
    """--verbose logs the stopwatch lines it logged before the spans, in
    the same words, and no profiler means no record."""
    with caplog.at_level(logging.DEBUG, logger="kiss_tpu_torch"):
        fm.FMIndex(sa_intv=4, device="cpu").build(_text())
    lines = [re.sub(r"\d+\.\d+", "<t>", r.getMessage())
             for r in caplog.records if r.name == "kiss_tpu_torch"]
    assert lines == [
        "seed_sort(chars=64) elapsed <t>",
        "wide_round[0](cover 64->512) elapsed <t>",
        "tail_refine[0](m=7938, cover=512) elapsed <t>",
        "tail_refine[1](m=770, cover=4096) elapsed <t>",
        "k_ordered_suffix_array elapsed <t>",
        "fmindex build elapsed <t>",
    ]
    assert timing.RECORDS == []


def test_names_and_nesting(traced):
    """kiss.build > kiss.sort > its seed, round and tails; the tables and
    the block table beside the sort; the query spans at the top."""
    _, recs, _, _ = traced
    tree = [(r.name, recs[r.parent].name if r.parent >= 0 else None)
            for r in recs]
    assert tree == [
        ("kiss.build", None),
        ("kiss.sort", "kiss.build"),
        ("kiss.sort.seed", "kiss.sort"),
        ("kiss.sort.round", "kiss.sort"),
        ("kiss.sort.tail", "kiss.sort"),
        ("kiss.sort.tail", "kiss.sort"),
        ("kiss.build.tables", "kiss.build"),
        ("kiss.build.block_table", "kiss.build"),
        ("kiss.query.search", None),
        ("kiss.query.locate", None),
        ("kiss.query.bfs", None),
    ]
    assert all(0 < r.start_ns <= r.end_ns for r in recs)
    for r in recs:  # a child lies inside its parent
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_summary_self_time_is_duration_less_children(traced):
    _, recs, summary, _ = traced
    assert summary["kiss.sort.tail"]["count"] == 2
    for name, s in summary.items():
        own = [i for i, r in enumerate(recs) if r.name == name]
        ns = sum(recs[i].end_ns - recs[i].start_ns for i in own)
        kids = sum(r.end_ns - r.start_ns for r in recs if r.parent in own)
        assert s["count"] == len(own)
        assert s["host_ms"] == pytest.approx(ns / 1e6, rel=1e-12)
        assert s["self_host_ms"] == pytest.approx((ns - kids) / 1e6,
                                                  rel=1e-12, abs=1e-9)
        assert 0 <= s["self_host_ms"] <= s["host_ms"]
        assert s["device_ms"] is None  # no CUDA in use
        # K1's counters count the card's sorts; K2's its patterns anywhere,
        # the sort's its rows and the tail's tied rows (_text) anywhere
        sort = {"sort_rows": 40_001, "sort_rows_tied": 7_938 + 770}
        want = {"kiss.query.search": {"k2_queries": 100,
                                      "k2_lookup_reads": 0},
                "kiss.build": sort, "kiss.sort": sort,
                "kiss.sort.tail": {"sort_rows_tied": 7_938 + 770}}
        assert s["counts"] == want.get(name, {})


def test_events_are_host_events_only(traced):
    """Every kiss.* event of the trace is a CPU event and no user
    annotation (which the profiler would mirror onto a device's
    timeline); one event a record."""
    prof, recs, _, _ = traced
    events = [e for e in prof.events() if e.name.startswith("kiss.")]
    assert sorted(e.name for e in events) == sorted(r.name for r in recs)
    for e in events:
        assert e.device_type == DeviceType.CPU
        assert e.is_user_annotation is False


def test_records_are_on_the_profilers_clock(traced):
    """Each record starts within 1 ms of its event's start, the trace's
    start plus the event's offset."""
    prof, recs, _, _ = traced
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name.startswith("kiss.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == [r.name for r in recs]
    for e, r in zip(events, recs):
        assert abs(t0 + e.time_range.start * 1e3 - r.start_ns) < 1e6
        assert abs(t0 + e.time_range.end * 1e3 - r.end_ns) < 1e6


def test_answers_under_the_profiler_are_the_plain_ones(traced):
    *_, (walk, bfs) = traced
    text = _text()
    index = fm.FMIndex(sa_intv=4, device="cpu").build(text)
    assert _query_all(index, text) == (walk, bfs)
    assert walk[0] == bfs[0] > 0


def test_add_lands_on_the_innermost_open_span():
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("kiss.outer"):
            timing.add("k1_keys", 3)
            with timing.span("kiss.inner"):
                timing.add("k1_keys", 10)
                timing.add("k1_key_words", 40)
            with timing.span("kiss.inner"):
                timing.add("k1_keys", 1)
        timing.add("k1_keys", 100)  # no span open: nowhere
    assert [(r.name, r.counts) for r in timing.RECORDS] == [
        ("kiss.outer", {"k1_keys": 3}),
        ("kiss.inner", {"k1_keys": 10, "k1_key_words": 40}),
        ("kiss.inner", {"k1_keys": 1}),
    ]
    summary = timing.span_summary()
    assert summary["kiss.inner"]["counts"] == {"k1_keys": 11,
                                               "k1_key_words": 40}
    assert summary["kiss.outer"]["counts"] == {"k1_keys": 14,
                                               "k1_key_words": 40}
    assert summary["kiss.outer"]["count"] == 1


def test_add_does_nothing_when_tracing_is_off():
    with timing.span("kiss.outer"):
        timing.add("k1_keys", 3)
    assert timing.RECORDS == [] and timing.span_summary() == {}


def test_reset_spans_clears_the_records():
    with profile(activities=[ProfilerActivity.CPU]):
        ss.k_ordered_suffix_array(_text(), 256, device="cpu")
    assert [r.name for r in timing.RECORDS] == [
        "kiss.sort", "kiss.sort.seed", "kiss.sort.round"]
    timing.reset_spans()
    assert timing.RECORDS == [] and timing.span_summary() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("kiss.again"):
            pass
    assert [r.name for r in timing.RECORDS] == ["kiss.again"]
    assert timing.RECORDS[0].parent == -1


def test_a_span_that_raises_still_closes():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with timing.span("kiss.outer"):
                with timing.span("kiss.inner"):
                    raise ValueError("inside")
        with timing.span("kiss.after"):
            pass
    assert [(r.name, r.parent) for r in timing.RECORDS] == [
        ("kiss.outer", -1), ("kiss.inner", 0), ("kiss.after", -1)]
    assert all(r.end_ns for r in timing.RECORDS)

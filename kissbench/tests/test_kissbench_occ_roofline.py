"""The reader ``occ_roofline.build`` (K6 ``occ_tables``' share of its
roofline in the build cells) on the CPU: None where the program counted
nothing (no span, a span without K6's counters, a build whose tables the
plain version made), and the share its arithmetic gives on a made-up
summary: 40 bytes an lf_tab row and 32 an occ1 row over 3.35 TB/s, over
``occ_tables.cu``'s device time."""

from __future__ import annotations

import os

import numpy as np
import pytest

from kissbench import trace
from kissbench.run import load_file
from kissbench.tests import helpers

# the build cell's rows, N = 248,387,329: N // 16 + 1 rows of lf_tab and
# N // 256 + 1 of occ1
WORDS, SUPS = 15_524_209, 970_264


def _reader():
    return load_file(os.path.join(helpers.REPO, "kissbench", "metrics",
                                  "occ_roofline.build.py"),
                     "m_occ_roofline_build")


def _summary(seconds: float) -> trace.Summary:
    return trace.Summary(window_s=1.0, busy_s=0.9, ops=1, device_s={
        ("occ_tables_kernel", "occ_tables.cu"): seconds,
        ("onesweep_pass_kernel", "radix_sort.cu"): 0.2,
    })


@pytest.fixture
def spans():
    from kiss_tpu_torch.utils import timing

    timing.reset_spans()
    yield timing
    timing.reset_spans()


def test_none_without_the_counters(spans):
    read = _reader().read
    assert read(_summary(4e-4), {}) is None  # no span at all
    spans.RECORDS.append(spans.SpanRecord("kiss.build", -1, 0, 10,
                                          counts={"k1_keys": 5}))
    assert read(_summary(4e-4), {}) is None


def test_none_after_a_build_on_the_cpu(spans):
    from torch.profiler import ProfilerActivity, profile

    from kiss_tpu_torch.models import fm_index as fm

    text = np.random.default_rng(3).integers(0, 4, 3000).astype(np.int8)
    with profile(activities=[ProfilerActivity.CPU]):
        fm.FMIndex(sa_intv=4, lookup_len=0, device="cpu").build(text)
    found = spans.span_summary()
    assert "kiss.build" in found and "occ_words" not in found[
        "kiss.build"]["counts"]
    assert _reader().read(_summary(4e-4), {}) is None


def test_the_share_of_a_made_up_summary(spans):
    tables = spans.SpanRecord("kiss.build.tables", 0, 2, 8,
                              counts={"occ_words": WORDS, "occ_sups": SUPS})
    spans.RECORDS.extend([spans.SpanRecord("kiss.build", -1, 0, 10), tables])
    bound_ms = (40 * WORDS + 32 * SUPS) / 3.35e12 * 1e3
    got = _reader().read(_summary(4e-4), {})
    assert got == pytest.approx(100 * bound_ms / 0.4, rel=1e-12)
    assert 48 < got < 49  # 652 MB: 0.1947 ms of 0.4
    # the kernel absent from the trace: nothing to read
    s = _summary(0.0)
    assert _reader().read(s, {}) is None

"""The program's own spans and counters, for the per-layer readers that
read them: ``kiss_tpu_torch.utils.timing.span_summary()``, the library's
phases (``kiss.sort.round``, ``kiss.build.tables``, ``kiss.query.*``) and
the counts added inside them (K1's keys and key words). The program keeps
its spans only while a profiler records, so in a traced run they are the
traced window's. A program without spans gives nothing, and the metrics
that read them are left out of the line."""

from __future__ import annotations

from kissbench import bounds
from kissbench.readers import roofline_pct


def summary() -> dict:
    """``{span name: {"count", "host_ms", "self_host_ms", "device_ms",
    "counts"}}`` of the program, or {} where it keeps no spans."""
    from kiss_tpu_torch.utils import timing

    read = getattr(timing, "span_summary", None)
    return read() if read is not None else {}


def device_ms_per_op(s, name: str) -> float | None:
    """Device milliseconds an operation of the traced window inside the
    spans ``name`` (CUDA events around each); None where none ran or they
    were not timed on the device."""
    span = summary().get(name)
    if span is None or span["device_ms"] is None or s.ops <= 0:
        return None
    return span["device_ms"] / s.ops


def self_host_ms_per_op(s, names) -> float | None:
    """Host milliseconds an operation of the traced window inside the spans
    ``names``, less their child spans; None where none ran, or where the
    device ran nothing (the CPU's plain versions compute inside the spans,
    so their host time is not the host's part of a card's operation)."""
    found = summary()
    ran = [found[n]["self_host_ms"] for n in names if n in found]
    if not ran or s.ops <= 0 or s.busy_s <= 0:
        return None
    return sum(ran) / s.ops


def k1_roofline(s, top: str) -> float | None:
    """K1's share of its roofline in the traced window: ``bounds.bound_ms``
    of the keys and key words that K1's launches inside the spans ``top``
    counted (the key words read and written once, 8 bytes a key of
    permutation, a digit step a key byte: ``utils/roofline.k1_bound``'s
    arithmetic) over the device time of ``radix_sort.cu``, in percent;
    None where K1 counted nothing or did not run."""
    span = summary().get(top)
    if span is None:
        return None
    keys = span["counts"].get("k1_keys", 0)
    words = span["counts"].get("k1_key_words", 0)
    if words <= 0:
        return None
    return roofline_pct(bounds.bound_ms(8 * words + 8 * keys, 4 * words)[0],
                        s, "radix_sort.cu")

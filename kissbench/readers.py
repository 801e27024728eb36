"""Arithmetic shared by the per-layer readers (``metrics/<name>.py``): each
takes the reduced trace (``trace.Summary``) and returns a number, or None
where the trace holds nothing for it (the metric is then left out)."""

from __future__ import annotations


def idle_pct(s) -> float | None:
    """The share of the traced window in which the device ran nothing."""
    if s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def per_op_ms(seconds: float, s) -> float | None:
    """Device milliseconds an operation of the traced window."""
    if seconds <= 0 or s.ops <= 0:
        return None
    return seconds * 1e3 / s.ops


def roofline_pct(bound_ms: float | None, s, source: str) -> float | None:
    """The least time of a kernel's work over its device time in the
    window, in percent; None where the kernel did not run."""
    ran_ms = s.seconds_of(source=source) * 1e3
    if not bound_ms or ran_ms <= 0:
        return None
    return 100.0 * bound_ms / ran_ms

"""Helpers the metric readers share."""

from __future__ import annotations


def device_idle(run):
    """Percent of the traced window with no kernel or copy on the
    device, or None untraced."""
    t = run.trace
    if t is None or t.window_s <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)

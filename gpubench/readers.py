"""What the metric readers (`metrics/<name>.py`) compute, from a run's
`harness.Record`. A reader returns None where its run has nothing to read,
and the metric is then left out of the result line."""

from __future__ import annotations

import math
import statistics

from gpubench import peaks


def rate(rec) -> float | None:
    """Requests completed over the window's seconds."""
    return rec.completed / rec.window_s if rec.completed else None


def p95_ms(rec) -> float | None:
    """The 95th percentile of every request's latency in the window
    (nearest rank), in ms."""
    lat = sorted(rec.latencies_s)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


def setup_s(rec) -> float:
    return rec.setup_s


def device_idle_pct(rec) -> float | None:
    """The share of the traced stretch in which nothing ran on the device."""
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(rec) -> float | None:
    """Model operations of the traced requests over the traced stretch's
    seconds at the bf16 peak. The stretch, not the window: a traced run's
    window also holds the profiler's start and stop."""
    t = rec.trace
    if t is None or t.window_s <= 0 or not rec.ops_per_request:
        return None
    return 100.0 * rec.ops_per_request * t.requests / (
        t.window_s * peaks.BF16_FLOPS)


def roofline_pct(rec) -> float | None:
    """The least time the traced requests need over the device's busy time
    in the traced stretch."""
    t = rec.trace
    if t is None or t.busy_s <= 0 or not rec.least_s_per_request:
        return None
    return 100.0 * rec.least_s_per_request * t.requests / t.busy_s


def span_mean_ms(name: str):
    """A reader of the mean of the driver's span `name`, in ms."""
    def read(rec) -> float | None:
        v = rec.spans_s.get(name)
        return 1e3 * statistics.fmean(v) if v else None
    return read


def range_mean_ms(name: str):
    """A reader of the host ms per traced request spent in the range
    `name` of the program (a `record_function` range)."""
    def read(rec) -> float | None:
        t = rec.trace
        if t is None or name not in t.ranges_s:
            return None
        return 1e3 * t.ranges_s[name] / t.requests
    return read

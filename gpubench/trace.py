"""Reduce a `torch.profiler` trace of a stretch of the window to numbers.

The profiler keeps its records in memory; nothing is written to disk.
From the device's records (kernels, copies, sets) come the busy time (the
union of their intervals), the device operations that took the most time,
and the idle gaps between them, each labelled by the innermost host range
open at the gap's middle: a benchmark span (`bench/...`), a range of the
program (`reg/...`) or the torch operation the host was in; and the host
seconds spent in each named range.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

TOP = 10


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    requests: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    ranges_s: dict = field(default_factory=dict)  # host seconds by range


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, span: str = "bench/request") -> TraceSummary:
    """`prof` a stopped `torch.profiler.profile` around whole requests,
    each inside a host range named `span`: the traced stretch runs from
    the first such range's start to the last one's end."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    dev, host, spans = [], [], []
    ranges: dict[str, float] = defaultdict(float)
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a host range mirrored on the device's timeline is no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in host_names):
                dev.append((e.name, a, b))
        elif e.device_type == DeviceType.CPU and b > a:
            host.append((e.name, a, b))
            if e.name == span:
                spans.append((a, b))
            if "/" in e.name:  # a named range (`record_function`)
                ranges[e.name] += (b - a) * 1e-6
    if not spans:
        raise RuntimeError(f"the trace holds no {span!r} range")
    t0, t1 = min(a for a, _ in spans), max(b for _, b in spans)
    busy = _merge([(max(a, t0), min(b, t1)) for _, a, b in dev
                   if b > t0 and a < t1])

    per_op: dict[str, float] = defaultdict(float)
    for name, a, b in dev:
        if b > t0 and a < t1:
            per_op[name] += (min(b, t1) - max(a, t0)) * 1e-6
    device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]

    # label each idle gap by the innermost host range open at its middle
    host.sort(key=lambda h: h[1])
    gaps: dict[str, float] = defaultdict(float)
    edges = [t0] + [v for iv in busy for v in iv] + [t1]
    active: list = []
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][1] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[2] > mid]
        label = min(active, key=lambda h: h[2] - h[1])[0] if active else (
            "host outside every range")
        gaps[label] += (b - a) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        busy_s=sum(b - a for a, b in busy) * 1e-6, window_s=(t1 - t0) * 1e-6,
        requests=len(spans), device_ops=[[n, v] for n, v in device_ops],
        idle_gaps=[[n, v] for n, v in idle], ranges_s=dict(ranges))

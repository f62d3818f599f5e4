"""Device seconds of a traced stretch by the program's range that launched
them.

Every device record (kernel, copy, set) shares its correlation id with the
CUDA runtime or driver call that launched it (`cudaLaunchKernel`,
`cuLaunchKernel`, `cudaMemcpyAsync`, ...), a host event named `cu...`. The
record is credited to the innermost named (`/`) host range open when that
call started. The port's own kernels launch through ctypes, outside any
torch operation, so the profiler's link from a record to a torch operation
(`kernels`, `linked_correlation_id`) misses them; the launch call's time
does not. Records are clipped to the stretch as `trace.summarize` clips
its `device_ops`; those with no launch call in the trace, or launched
outside every named range, go under its label for time outside every
range, so the values sum to the device time of every record in the
stretch.

`trace.summarize` does not call this yet, so no metric reads it: a metric
of device time under a program range (`extract/input`, `sliding/*`,
`unet/norm_stats`) needs `TraceSummary` to carry its result.
"""

from __future__ import annotations

from collections import defaultdict

OUTSIDE = "host outside every range"


def device_by_span(prof, span: str = "bench/request") -> dict[str, float]:
    """Device seconds by launching range over the stretch from the first
    `span` range's start to the last one's end (`prof` as
    `trace.summarize` takes it)."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in host}
    spans = [(e.time_range.start, e.time_range.end) for e in host
             if e.name == span and e.time_range.end > e.time_range.start]
    if not spans:
        raise RuntimeError(f"the trace holds no {span!r} range")
    t0, t1 = min(a for a, _ in spans), max(b for _, b in spans)
    # found by name: a torch operation's id may equal a launch call's
    launches = {e.id: e.time_range.start for e in host
                if e.name.startswith("cu")}
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in host if "/" in e.name))
    records = []  # (launch time or None, clipped seconds)
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        # a host range mirrored on the device's timeline is no work
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.name not in host_names and b > t0 and a < t1):
            records.append((launches.get(e.id),
                            (min(b, t1) - max(a, t0)) * 1e-6))
    out: dict[str, float] = defaultdict(float)
    active: list = []
    j = 0
    for t, seconds in sorted(records, key=lambda r: (r[0] is None, r[0])):
        if t is None:
            out[OUTSIDE] += seconds
            continue
        while j < len(ranges) and ranges[j][0] <= t:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r[1] > t]
        out[min(active, key=lambda r: r[1] - r[0])[2] if active
            else OUTSIDE] += seconds
    return dict(out)

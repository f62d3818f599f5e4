"""95th percentile of one volume's latency over every volume of the
window, host-to-device copy and device wait included (ms)."""

from gpubench.readers import p95_ms as read  # noqa: F401

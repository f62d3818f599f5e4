"""Host ms per traced pair in the program's `reg/extract` range (the
features of both volumes)."""

from gpubench.readers import range_mean_ms

read = range_mean_ms("reg/extract")

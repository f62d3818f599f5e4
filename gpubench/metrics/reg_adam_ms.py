"""Host ms per traced pair in the program's `reg/adam` range (the 80
Adam iterations of the instance optimisation)."""

from gpubench.readers import range_mean_ms

read = range_mean_ms("reg/adam")

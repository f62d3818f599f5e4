"""Host ms per traced volume in the program's `extract/input` range: the
volume's host-to-device copy from pageable memory, which returns once the
copy has been staged (and `full`'s pad to the pooling stride). Read alike
under each path's name (`input_host_ms.full`, `.sliding`)."""

from gpubench.readers import range_mean_ms

read = range_mean_ms("extract/input")

"""Mean host ms from the call of the extractor to its return, before
the device is waited for, per volume. Read alike under each path's name
(`host_enqueue_ms.full`, `.sliding`)."""

from gpubench.readers import span_mean_ms

read = span_mean_ms("enqueue")

"""Host ms per traced volume in the program's `sliding/setup` range: the
stitch loop's set-up (the pad to roi, window starts, the Gaussian maps,
the blend weight map, the copies of starts, mask and axes to the device,
the canvas), rebuilt on every call."""

from gpubench.readers import range_mean_ms

read = range_mean_ms("sliding/setup")

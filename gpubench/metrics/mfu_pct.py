"""Model FLOPs of the requests completed in the traced stretch (the UNet
on each volume, each conv once, every window of `sliding`; a pair counts
both volumes and not the solver) over the stretch at 989 TFLOP/s (%).
Read alike under each path's name (`mfu_pct.full`, `.sliding`,
`.register`)."""

from gpubench.readers import mfu_pct as read  # noqa: F401

"""The least time the traced volumes need (per conv, norm, pool,
upsample and stitch: the larger of FLOPs at 989 TFLOP/s and bytes at
3.35 TB/s) over the card's busy time in the traced stretch (%). Read
alike under each path's name (`extract_roofline.full`, `.sliding`)."""

from gpubench.readers import roofline_pct as read  # noqa: F401

"""Share of the traced stretch in which no kernel or copy ran on the
card (%). Read alike under each path's name (`device_idle_pct.full`,
`.sliding`, `.register`), each moving its own cells' rate."""

from gpubench.readers import device_idle_pct as read  # noqa: F401

"""Volumes completed per second in the window, by the host clock. Read
alike under each path's name (`volumes_per_s.full`, `.sliding`), which
hold bounds of their own."""

from gpubench.readers import rate as read  # noqa: F401

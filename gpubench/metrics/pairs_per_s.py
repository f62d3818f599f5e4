"""Pairs registered per second in the window, by the host clock:
features of both volumes, the merge and the solver."""

from gpubench.readers import rate as read  # noqa: F401

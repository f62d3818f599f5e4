"""Seconds from the process's start to the window's: imports, kernel
loading (and building, in a first run), weights, inputs, warm-up."""

from gpubench.readers import setup_s as read  # noqa: F401

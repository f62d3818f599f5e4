"""Utilities of the port: NIfTI IO, checkpoints, scalar logging, figures
and volume dumps, profiling hooks."""

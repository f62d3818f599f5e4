"""Utilities of the port (NIfTI IO)."""

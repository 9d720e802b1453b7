"""Utilities of the port (checkpoint files)."""

"""Utilities of the port (checkpoint files, image output)."""

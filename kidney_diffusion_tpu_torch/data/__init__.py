"""Whole-slide geometry of the port (`wsi.py`); the slide readers and the
dataset pipeline are not ported yet."""

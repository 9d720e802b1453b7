"""Device image ops of the port (`image.py`: HSV, binary morphology, tissue
masks); `augment.py` is not ported yet."""

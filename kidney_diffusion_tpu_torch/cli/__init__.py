"""Command-line entry points of the port (`python -m
kidney_diffusion_tpu_torch.cli.<name>`): gigapixel sampling so far."""

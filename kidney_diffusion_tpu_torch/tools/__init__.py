"""Measurement entry points of the port (`python -m kidney_diffusion_tpu_torch.tools.<name>`)."""

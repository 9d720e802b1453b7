"""PyTorch/CUDA port of `kidney_diffusion_tpu` for NVIDIA Hopper.

The package mirrors the JAX package's layout (`models/`, `core/`,
`kernels/`, `cascade.py`) so each module's counterpart is easy to find.
It imports `torch` only — never `jax`, `flax` or `kidney_diffusion_tpu`.
Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""

from .device import resolve_device

__version__ = "0.1.0"  # the port's own; stored in its checkpoints' metadata

__all__ = ["resolve_device"]

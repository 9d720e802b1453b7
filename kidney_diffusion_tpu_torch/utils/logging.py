"""Image output of the port.

`save_image` is the counterpart of `kidney_diffusion_tpu/utils/logging.py::
save_image`; it imports PIL only when called, so the port runs on a host
without PIL as long as nothing is saved.
"""

from __future__ import annotations

import numpy as np


def save_image(image, path: str) -> None:
    """Save an HWC [0, 1] float or uint8 image (numpy or a tensor; NHWC
    takes the first image) as PNG/JPG."""
    from PIL import Image

    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim == 4:
        arr = arr[0]
    Image.fromarray(arr).save(path)

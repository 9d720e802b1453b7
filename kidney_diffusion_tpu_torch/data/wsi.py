"""Multi-magnification geometry of whole-slide images.

Port of the geometry half of `kidney_diffusion_tpu/data/wsi.py`: the
magnification level sizes, the fill colours, the host-side nearest resize
and the width of a patch of one level inside the image of the level above.
The slide readers are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# source pixels per 1024² model patch per magnification level
MAG_LEVEL_SIZES = (40000, 6500, 1024)
AIRS_MAG_LEVEL_SIZES = (10000, 3328, 1024)
FILL_COLOR = (242, 243, 242)
AIRS_FILL_COLOR = (0, 0, 0)
PATCH_SIZE = 1024


def resize_nearest(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Nearest-neighbour resize of an HWC array: output pixel i reads input
    floor((i + 0.5) * in / out)."""
    h, w = img.shape[:2]
    if h == out_h and w == out_w:
        return img
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h, 0, h - 1).astype(np.int64)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w, 0, w - 1).astype(np.int64)
    return img[ys][:, xs]


def inner_patch_width(
    mag_level: int,
    *,
    patch_size: int = PATCH_SIZE,
    mag_sizes: Tuple[int, ...] = MAG_LEVEL_SIZES,
) -> int:
    """Width (px) of a mag-k patch inside a generated mag-(k-1) image."""
    return int(mag_sizes[mag_level] * patch_size / mag_sizes[mag_level - 1])

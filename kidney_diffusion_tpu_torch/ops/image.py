"""Image ops on a device: HSV conversion, binary morphology, tissue masks.

Port of `kidney_diffusion_tpu/ops/image.py`. Each runs on `device`
("cuda" unless the caller asks for "cpu"; numpy or tensor input is moved
there); the mag-2 tissue filter of the gigapixel sampler calls them on
the stitched mag-1 canvas. The morphology is two separable max passes (rows, then columns)
over a padded mask, which give the same result as one size x size window:
erode pads with 1 and dilate with 0, as the JAX package's `reduce_window`
does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

Tensor = torch.Tensor


def _as_tensor(x, device, dtype) -> Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=resolve_device(device), dtype=dtype)


def rgb_to_hsv(rgb, device="cuda") -> Tensor:
    """RGB [0, 1] (..., 3) -> HSV [0, 1] (..., 3), fp32, as
    skimage.color.rgb2hsv defines it."""
    rgb = _as_tensor(rgb, device, torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    zero, one = torch.zeros_like(maxc), torch.ones_like(maxc)
    safe_delta = torch.where(delta == 0, one, delta)
    s = torch.where(maxc == 0, zero, delta / torch.where(maxc == 0, one, maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, zero, h)
    return torch.stack([h, s, v], dim=-1)


def _morph(mask, size: int, op: str, device) -> Tensor:
    """Binary erode / dilate of a (H, W) or (N, H, W) mask with a size x size
    all-ones structuring element (cv2.erode / cv2.dilate); bool out."""
    m = _as_tensor(mask, device, torch.float32)
    squeeze = m.ndim == 2
    if squeeze:
        m = m[None]
    lo = size // 2
    hi = size - 1 - lo
    if op == "erode":  # min with pad 1 == 1 - max of the complement with pad 0
        m = 1.0 - m
    m = F.pad(m[:, None], (lo, hi, lo, hi), value=0.0)
    m = F.max_pool2d(m, (size, 1), stride=1)
    m = F.max_pool2d(m, (1, size), stride=1)[:, 0]
    if op == "erode":
        m = 1.0 - m
    out = m > 0.5
    return out[0] if squeeze else out


def binary_erode(mask, size: int = 5, device="cuda") -> Tensor:
    return _morph(mask, size, "erode", device)


def binary_dilate(mask, size: int = 51, device="cuda") -> Tensor:
    return _morph(mask, size, "dilate", device)


def tissue_mask(
    rgb,
    *,
    hue_min: float = 0.5,
    sat_min: float = 0.02,
    value_min: Optional[float] = None,
    device="cuda",
) -> Tensor:
    """HSV-threshold tissue detection. Kidney WSI: hue > 0.5 & sat > 0.02
    (loose) or hue > 0.8 & sat > 0.05 (strict); AIRS aerial: value > 0.1."""
    hsv = rgb_to_hsv(rgb, device)
    if value_min is not None:
        return hsv[..., 2] > value_min
    return (hsv[..., 0] > hue_min) & (hsv[..., 1] > sat_min)


def foreground_mask_for_patches(
    rgb,
    *,
    airs: bool = False,
    erode_size: int = 5,
    dilate_size: int = 51,
    device="cuda",
) -> Tensor:
    """The mag-2 patch filter: tissue mask -> erode (remove specks) ->
    dilate (grow)."""
    if airs:
        m = tissue_mask(rgb, value_min=0.1, device=device)
    else:
        m = tissue_mask(rgb, hue_min=0.5, sat_min=0.02, device=device)
    m = binary_erode(m, erode_size, device=m.device)
    return binary_dilate(m, dilate_size, device=m.device)

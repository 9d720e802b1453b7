"""The port's image ops (`kidney_diffusion_tpu_torch/ops/image.py`) against
the JAX package's: HSV within 1e-6, masks and morphology exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu.ops import image as jimg
from kidney_diffusion_tpu_torch.ops import image as timg


def _rgb(seed, shape=(37, 41, 3)):
    """Random colours with the cases HSV branches on: greys (delta 0),
    black, and ties between the largest channels."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=shape).astype(np.float32)
    rgb[0, :5] = rgb[0, :5, :1]  # greys
    rgb[1, :3] = 0.0  # black
    rgb[2, :4, :2] = 0.7  # r == g is the max
    rgb[3, :4, 1:] = 0.9  # g == b is the max
    rgb[4, :4] = (0.2, 0.5, 0.9)  # b is the max
    return rgb


@pytest.mark.parametrize("seed", [0, 1])
def test_rgb_to_hsv(seed):
    rgb = _rgb(seed)
    want = np.asarray(jimg.rgb_to_hsv(jnp.asarray(rgb)))
    got = timg.rgb_to_hsv(rgb, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _mask(seed, shape=(48, 53), p=0.3):
    return np.random.default_rng(seed).uniform(size=shape) < p


@pytest.mark.parametrize("op", ["erode", "dilate"])
@pytest.mark.parametrize("size", [3, 4, 5, 51])
def test_binary_morphology(op, size):
    """Separable row and column max passes give the size x size window's
    result, with the JAX package's padding (erode 1, dilate 0), also for an
    even size, a window wider than the mask, and a batch of masks."""
    mask = _mask(size, p=0.7 if op == "erode" else 0.05)
    jfn, tfn = getattr(jimg, f"binary_{op}"), getattr(timg, f"binary_{op}")
    np.testing.assert_array_equal(tfn(mask, size, device="cpu").numpy(),
                                  np.asarray(jfn(mask, size)))
    batch = np.stack([mask, _mask(size + 1, p=0.5)])
    np.testing.assert_array_equal(tfn(torch.from_numpy(batch), size, device="cpu").numpy(),
                                  np.asarray(jfn(batch, size)))


@pytest.mark.parametrize("airs", [False, True])
def test_foreground_mask_for_patches(airs):
    """The mag-2 filter on an image with tissue-coloured blobs on a pale
    background (kidney thresholds) or bright blobs on black (AIRS)."""
    rng = np.random.default_rng(3)
    h = w = 160
    img = np.full((h, w, 3), 0.0 if airs else 0.95, np.float32)
    img += rng.uniform(-0.03, 0.03, size=img.shape).astype(np.float32)
    for _ in range(6):
        y, x, r = rng.integers(10, 150), rng.integers(10, 150), rng.integers(2, 12)
        img[max(y - r, 0):y + r, max(x - r, 0):x + r] = (0.6, 0.3, 0.7)
    img = np.clip(img, 0, 1)
    want = np.asarray(jimg.foreground_mask_for_patches(jnp.asarray(img), airs=airs))
    got = timg.foreground_mask_for_patches(img, airs=airs, device="cpu").numpy()
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    tm = timg.tissue_mask(img, hue_min=0.8, sat_min=0.05, device="cpu").numpy()
    np.testing.assert_array_equal(
        tm, np.asarray(jimg.tissue_mask(jnp.asarray(img), hue_min=0.8, sat_min=0.05)))


def test_image_ops_default_to_the_card(monkeypatch):
    """Without a card the ops raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timg.foreground_mask_for_patches(np.zeros((8, 8, 3), np.float32))

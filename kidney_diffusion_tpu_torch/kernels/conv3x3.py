"""Fused 3x3 SAME convolution over NHWC: CUDA kernel, plain version, wrapper.

Port of `kidney_diffusion_tpu/kernels/conv3x3.py`. The function is
`y = conv3x3(pro(x)) + b` with fp32 accumulation, where the optional
prologue `pro` (B, 2, Cin) = [a; c] is silu(x * a + c) applied before the
taps with the SAME padding zeros after it, and the optional stats are
(B, 2, Cout) = [sum(y), centered sumsq Q] computed from the PRE-bias output
(variance-safe: Q is shift-invariant, so a large bias cannot cancel it).
With `chunks > 0` the input is a batch of row chunks (B*chunks, rows, W, C),
an image's chunks contiguous top to bottom; the conv is exactly the SAME
conv on the unchunked image and the stats come back per chunk. `pro` must
then be the same for all chunks of an image (`gn_film_affine(chunks=...)`
makes it so): the kernel applies a chunk's own affine to the halo row it
reads from its neighbour, the plain version the neighbour's.

`conv3x3` runs the plain version for a tensor on the CPU and the CUDA
kernel (`csrc/conv3x3.cu`) for a tensor on the card; there is no fallback
from one to the other. The int8 and range-epilogue options of the JAX
module belong to the quantised serving slice and are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def halo_pad(x: Tensor, chunks: int) -> Tensor:
    """Exchange one halo row between adjacent row chunks of each image.

    (B*chunks, rows, W, C) -> (B*chunks, rows+2, W, C): each chunk gains its
    upper neighbour's last row on top and its lower neighbour's first row at
    the bottom; image borders get zeros. A VALID-H conv on the result equals
    the SAME conv on the unchunked image."""
    bc, rows, w, c = x.shape
    if bc % chunks:
        raise ValueError(f"batch {bc} is not a multiple of chunks={chunks}")
    x5 = x.reshape(bc // chunks, chunks, rows, w, c)
    z = x.new_zeros((bc // chunks, 1, 1, w, c))
    top = torch.cat([z, x5[:, :-1, -1:]], dim=1)
    bot = torch.cat([x5[:, 1:, :1], z], dim=1)
    return torch.cat([top, x5, bot], dim=2).reshape(bc, rows + 2, w, c)


def apply_prologue(x: Tensor, pro: Tensor) -> Tensor:
    """silu(x * a + c) per (batch, channel) in fp32, back in x's dtype."""
    a = pro[:, 0].float()[:, None, None, :]
    c = pro[:, 1].float()[:, None, None, :]
    return F.silu(x.float() * a + c).to(x.dtype)


def finish_stats(s1z: Tensor, s2z: Tensor, npix: int, b: Optional[Tensor]) -> Tensor:
    """Raw pre-bias [sum z, sum z^2] (B, Cout) -> (B, 2, Cout) [sum y, Q]."""
    q = s2z - s1z * s1z / npix
    s1 = s1z + npix * b.float()[None, :] if b is not None else s1z
    return torch.stack([s1, q], dim=1)


def conv3x3_plain(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
                  pro: Optional[Tensor] = None, want_stats: bool = False,
                  chunks: int = 0):
    """Plain PyTorch version (`xla_conv3x3` without quant / range). Operands
    are rounded to x's dtype and multiplied in fp32, so products are exact
    and the sum is fp32, as `preferred_element_type=float32` does."""
    if pro is not None:
        x = apply_prologue(x, pro)
    wk = w.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    xin = x.float()
    if chunks:
        xin = halo_pad(xin, chunks)
        padding = (0, 1)
    else:
        padding = (1, 1)
    z = F.conv2d(xin.permute(0, 3, 1, 2), wk, padding=padding).permute(0, 2, 3, 1)
    y = z + b.float()[None, None, None, :] if b is not None else z
    out = y.to(x.dtype)
    if not want_stats:
        return out
    npix = z.shape[1] * z.shape[2]
    return out, finish_stats(z.sum(dim=(1, 2)), (z * z).sum(dim=(1, 2)), npix, b)


def tile_w(width: int) -> int:
    """Columns of the kernel's 64-pixel tile: 64 x 1 rows for wide maps,
    32 x 2 or 16 x 4 for narrow ones (a warp's 16 pixels stay in one row)."""
    return 64 if width > 32 else (32 if width > 16 else 16)


def _lib():
    lib = _build.library("conv3x3")
    fn = lib.kdt_conv3x3
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def conv3x3_cuda(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
                 pro: Optional[Tensor] = None, want_stats: bool = False,
                 chunks: int = 0):
    """Launch the CUDA kernel. bf16 activations and weights, fp32 bias,
    prologue and stats; raises on anything else."""
    global LAUNCHES
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3 wants NHWC x and (3, 3, Cin, Cout) w, got {x.shape}, {w.shape}")
    nb, h, wd, cin = x.shape
    cout = w.shape[-1]
    if w.shape[2] != cin:
        raise ValueError(f"input has {cin} channels, weights {w.shape[2]}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA conv3x3 takes bf16 activations, got {x.dtype}")
    if chunks and nb % chunks:
        raise ValueError(f"batch {nb} is not a multiple of chunks={chunks}")
    if nb > 65535 or cout > 64 * 65535:
        raise ValueError(f"batch {nb} or Cout {cout} exceeds the kernel's grid")
    dev = x.device
    if w.device != dev:
        raise ValueError(f"weights on {w.device}, activations on {dev}")
    x = _build.aligned(x)
    w = _build.aligned(w.to(torch.bfloat16))
    bias = b.to(device=dev, dtype=torch.float32).contiguous() if b is not None else None
    if pro is not None:
        if tuple(pro.shape) != (nb, 2, cin):
            raise ValueError(f"pro must be {(nb, 2, cin)}, got {tuple(pro.shape)}")
        pro = pro.to(device=dev, dtype=torch.float32).contiguous()
    tw = tile_w(wd)
    n_tiles = -(-wd // tw) * -(-h // (64 // tw))
    y = torch.empty((nb, h, wd, cout), dtype=torch.bfloat16, device=dev)
    partial = (torch.empty((nb, n_tiles, 2, cout), dtype=torch.float32, device=dev)
               if want_stats else None)
    lib = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.kdt_conv3x3(
        ptr(x), ptr(w), ptr(bias), ptr(pro), ptr(y), ptr(partial),
        nb, h, wd, cin, cout, int(chunks), tw,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "conv3x3")
    LAUNCHES += 1
    if not want_stats:
        return y
    s = partial.sum(dim=1)  # per-tile slots, summed in a fixed order
    return y, finish_stats(s[:, 0], s[:, 1], h * wd, b)


def conv3x3(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
            pro: Optional[Tensor] = None, want_stats: bool = False,
            chunks: int = 0):
    """3x3 SAME conv over NHWC with optional fused silu-affine prologue and
    [sum, centered sumsq] stats epilogue (see the module docstring).

    A tensor on the CPU runs the plain version; a tensor on the card runs
    the CUDA kernel or raises."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, pro=pro, want_stats=want_stats, chunks=chunks)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on the CPU or a CUDA device, not {x.device}")
    return conv3x3_cuda(x, w, b, pro=pro, want_stats=want_stats, chunks=chunks)

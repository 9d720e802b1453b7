"""Fused 3x3 SAME convolution over NHWC: CUDA kernel, plain version, wrapper.

Port of `kidney_diffusion_tpu/kernels/conv3x3.py`. The function is
`y = conv3x3(pro(x)) + b` with exact accumulation, where the optional
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

Options of the serving path (`xla_conv3x3` `:299-373`):

- `quant=True`: the w8a8 int8 conv of `_int8_conv`. The prologue'd input,
  rounded to its dtype, is quantized per tensor with s_a = max(a_max, 1e-8)
  / 127, where `a_max` is a given bound on its amax or, without one, its
  amax reduced in its own dtype; the weights per output channel; both as
  clip(round_half_even(v / s), -127, 127). Products sum exactly in int32
  and dequantize as float32(acc) * (s_a * s_w) before the bias.
- `want_range=True`: also return the post-bias per-channel [max, min]
  (B[*chunks], 2, Cout); with stats from the fp32 output plus the bias,
  without stats from the output in its dtype (JAX's two definitions).
- `bias_in_dtype=True`: out = dtype(dtype(z) + dtype(b)), the two roundings
  of `flax.linen.Conv(dtype)`, which the JAX U-Net uses for its unchunked
  init conv.

Returns `out`, `(out, stats)`, `(out, ranges)` or `(out, stats, ranges)`.

`conv3x3` runs the plain version for a tensor on the CPU and a CUDA kernel
for a tensor on the card; there is no fallback from one to the other. Three
hand-written kernels serve the card, chosen by `route`, a pure function of
(Cin, Cout, quant, bias_in_dtype):

- "wgmma" and "wgmma_int8" (`csrc/conv3x3_sm90.cu`): calls with Cin and
  Cout multiples of 64 — in bf16 with the conv's own bias rounding, every
  conv of the flagship U-Nets but the init and final convs; in int8, every
  int8 site. An implicit GEMM on Hopper's `wgmma` over tiles of 256 or 128
  pixels and 128 or 64 output channels, with a split over K for the small
  deep maps (`wide_config`); the int8 mode takes its weights K-major
  (`kmajor_weights`, laid out once per weight tensor) and quantizes the
  input while staging it.
- "narrow" (`csrc/conv3x3_narrow.cu`): bf16 init convs (Cin <= 16: 3 and 6
  on the flagship, 9, 10 and 12 at the conditioned stages) and final convs
  (Cout <= 8), either bias rounding (`narrow`).
- "wmma" (`csrc/conv3x3.cu`): the rest — ragged widths (Cout not a
  multiple of 64, int8 at ragged widths, Cin > 16), in either mode. No call
  of a served configuration comes here.

Gradients (`Conv3x3Function`, the counterpart of `_conv3x3_vjp`): while
autograd records, `conv3x3` runs the same forward (the kernel on the card,
the plain version on the CPU) inside an autograd function whose backward
differentiates the plain version on fp32 upcasts of the saved (x, w, b,
pro), as JAX's `_bwd` differentiates its all-fp32 reference: gradients of
`out` and `stats` (GroupNorm's statistics feed the next conv's prologue),
none of the ranges; the int8 mode is straight-through (the backward
differentiates the exact conv) and `a_max` gets no gradient. There is no
backward kernel: the recompute runs PyTorch's fp32 conv with TF32 off.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor
# (int8 (3, 3, Cin, Cout), fp32 (Cout,) scale), optionally followed by the
# int8 weights laid out K-major, (3, 3, Cout, Cin), for the wgmma int8 kernel
QuantWeights = Tuple[Tensor, ...]

# launches since the counts were last set to 0: bf16 calls (all kernels),
# the wgmma kernel's and the narrow kernel's shares of them; int8 calls
# (both kernels) and the wgmma int8 kernel's share of them
LAUNCHES = 0
LAUNCHES_WIDE = 0
LAUNCHES_NARROW = 0
LAUNCHES_INT8 = 0
LAUNCHES_INT8_WIDE = 0

# the wgmma kernel's tiles (rows, columns) of 128 and of 256 pixels, in
# order of preference at an equal tile count (smaller halo'd patch first)
WIDE_TILES = ((8, 16), (4, 32), (16, 8), (2, 64))
WIDE_TILES_256 = ((16, 16), (8, 32), (32, 8), (4, 64))
SMS = 132  # streaming multiprocessors of an H100 SXM: one wave of blocks
# the largest halo'd patch (pixels) with which two blocks of 128 pixels x
# 128 channels share an SM (`two_per_sm` in csrc/conv3x3_sm90.cu)
TWO_PER_SM_PATCH = 192
# input channels per slice of the wgmma kernels: 128-byte patch pixels
WIDE_KC = {False: 64, True: 128}
# the narrow kernel (csrc/conv3x3_narrow.cu): the final conv's tile (rows,
# columns) and the widths each of its two kernels takes
NARROW_OUT_TILE = (4, 64)
NARROW_MAX_COUT, NARROW_OUT_MAX_CIN = 8, 256
NARROW_MAX_CIN, NARROW_IN_MAX_COUT = 16, 512
# the init conv's tiles (rows, columns) by pixels a tile (128 / `narrow_in_groups`),
# columns a power of two, the halo'd patch at most 264 pixels; in order of
# preference at an equal tile count (smaller patch first)
NARROW_IN_TILES = {128: WIDE_TILES, 64: ((4, 16), (8, 8), (2, 32), (1, 64)),
                   32: ((2, 16), (4, 8), (1, 32))}

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


def quantize_weights(w: Tensor) -> QuantWeights:
    """Symmetric per-output-channel int8 weights of `_int8_conv`: s_w =
    max(max|w|, 1e-8) / 127 over (kh, kw, Cin), w_q = clip(round(w / s_w))."""
    wf = w.float()
    s_w = torch.clamp(wf.abs().amax(dim=(0, 1, 2)), min=1e-8) / 127.0
    wq = torch.clamp(torch.round(wf / s_w), -127, 127).to(torch.int8)
    return wq, s_w


def kmajor_weights(wq: Tensor) -> Tensor:
    """int8 weights (3, 3, Cin, Cout) laid out K-major, (3, 3, Cout, Cin):
    8-bit `wgmma` takes B only with K contiguous. Made once per weight
    tensor by a caller that reuses the weights (`Conv3x3.quantized_weights`)."""
    return wq.permute(0, 1, 3, 2).contiguous()


def activation_scale(x: Tensor, a_max: Optional[Tensor]) -> Tensor:
    """The per-tensor int8 scale (fp32 scalar) of the conv input `x` (after
    its prologue): from the bound `a_max`, else from x's amax in its dtype."""
    amax = a_max if a_max is not None else x.abs().amax()
    return torch.clamp(amax.float(), min=1e-8) / 127.0


def _finish(out: Tensor, stats, ranges):
    if stats is None and ranges is None:
        return out
    return tuple(t for t in (out, stats, ranges) if t is not None)


def conv3x3_plain(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
                  pro: Optional[Tensor] = None, want_stats: bool = False,
                  chunks: int = 0, quant: bool = False, a_max: Optional[Tensor] = None,
                  want_range: bool = False, bias_in_dtype: bool = False,
                  w_q: Optional[QuantWeights] = None):
    """Plain PyTorch version (`xla_conv3x3`). bf16 operands are multiplied in
    fp32, so products are exact and the sum is fp32, as
    `preferred_element_type=float32` does; int8 operands are convolved in
    float64, where every product and every partial sum (< 2^31) is an exact
    integer, so the sum is the exact int32 one."""
    if quant and bias_in_dtype:
        raise ValueError("bias_in_dtype is the plain conv's rounding; not with quant")
    if pro is not None:
        x = apply_prologue(x, pro)
    padding = (0, 1) if chunks else (1, 1)
    if quant:
        s_a = activation_scale(x, a_max)
        wq, s_w = (w_q if w_q is not None else quantize_weights(w))[:2]
        xin = torch.clamp(torch.round(x.float() / s_a), -127, 127).double()
        wk = wq.double().permute(3, 2, 0, 1)  # HWIO -> OIHW
    else:
        xin = x.float()
        wk = w.to(x.dtype).float().permute(3, 2, 0, 1)
    if chunks:
        xin = halo_pad(xin, chunks)
    z = F.conv2d(xin.permute(0, 3, 1, 2), wk, padding=padding).permute(0, 2, 3, 1)
    if quant:  # int -> fp32 (round to nearest even), then the scale product
        z = z.float() * (s_a * s_w)
    y = z + b.float() if b is not None else z
    if bias_in_dtype:
        out = z.to(x.dtype) + b.to(x.dtype) if b is not None else z.to(x.dtype)
    else:
        out = y.to(x.dtype)
    ranges = None
    if want_range:
        if want_stats:  # + b is monotone, so max(z) + b == max(z + b) exactly
            rmax, rmin = z.amax(dim=(1, 2)), z.amin(dim=(1, 2))
            if b is not None:
                rmax, rmin = rmax + b.float(), rmin + b.float()
        else:
            rmax, rmin = out.amax(dim=(1, 2)).float(), out.amin(dim=(1, 2)).float()
        ranges = torch.stack([rmax, rmin], dim=1)
    stats = None
    if want_stats:
        npix = z.shape[1] * z.shape[2]
        stats = finish_stats(z.sum(dim=(1, 2)), (z * z).sum(dim=(1, 2)), npix, b)
    return _finish(out, stats, ranges)


def tile_w(width: int) -> int:
    """Columns of the kernel's 64-pixel tile: 64 x 1 rows for wide maps,
    32 x 2 or 16 x 4 for narrow ones (a warp's 16 pixels stay in one row)."""
    return 64 if width > 32 else (32 if width > 16 else 16)


def narrow(cin: int, cout: int) -> bool:
    """Whether the narrow kernel takes a bf16 (Cin, Cout) call: a final conv
    (Cout <= 8, Cin a multiple of 64 up to 256) or an init conv (Cin <= 16,
    Cout a multiple of 64 up to 512)."""
    return ((cout <= NARROW_MAX_COUT and cin % 64 == 0 and 64 <= cin <= NARROW_OUT_MAX_CIN)
            or (cin <= NARROW_MAX_CIN and cout % 64 == 0 and 64 <= cout <= NARROW_IN_MAX_COUT))


def route(cin: int, cout: int, quant: bool = False, bias_in_dtype: bool = False) -> str:
    """Which kernel serves a call on the card: int8 calls with Cin and Cout
    multiples of 64 go to "wgmma_int8"; bf16 calls to "narrow" where
    `narrow` takes them (either bias rounding), else with Cin and Cout
    multiples of 64 and the conv's own bias rounding to "wgmma"; the rest
    (other ragged widths, in either mode) to "wmma"."""
    wide = cin % 64 == 0 and cout % 64 == 0
    if quant:
        return "wgmma_int8" if wide else "wmma"
    if narrow(cin, cout):
        return "narrow"
    return "wgmma" if wide and not bias_in_dtype else "wmma"


def narrow_in_groups(cout: int) -> int:
    """Channel groups the narrow init conv splits Cout into across its 8
    warps: a tile is 128 / groups pixels, so its staged output stays at most
    32 KB (`in_cg` in csrc/conv3x3_narrow.cu)."""
    return 1 if cout <= 128 else (2 if cout <= 256 else 4)


def _fewest_tiles(rows: int, width: int, tiles) -> Tuple[int, int]:
    """The tile (rows, columns) of `tiles` that covers a rows x width map
    with the fewest tiles, then with the smallest halo'd patch. A tile stays
    inside one batch item."""
    def cost(t):
        return -(-rows // t[0]) * -(-width // t[1]), (t[0] + 2) * (t[1] + 2)
    return min(tiles, key=cost)


def narrow_in_tile(rows: int, width: int, cout: int) -> Tuple[int, int]:
    """The narrow init conv's tile of 128 / `narrow_in_groups(cout)` pixels
    for a map of rows x width (`_fewest_tiles`)."""
    return _fewest_tiles(rows, width, NARROW_IN_TILES[128 // narrow_in_groups(cout)])


def wide_tile(rows: int, width: int, pixels: int = 128) -> Tuple[int, int]:
    """The wgmma kernel's tile of `pixels` (128 or 256) for a map of rows x
    width (`_fewest_tiles`)."""
    return _fewest_tiles(rows, width, WIDE_TILES if pixels == 128 else WIDE_TILES_256)


def wide_bn(n_tiles: int, nb: int, cout: int) -> int:
    """Output channels per block of the wgmma kernel: 128, or 64 where 128
    would leave part of the card's first wave of blocks empty (small deep
    maps) or Cout is an odd multiple of 64."""
    if cout % 128 or n_tiles * nb * (cout // 128) < SMS:
        return 64
    return 128


def wide_split(n_tiles: int, nb: int, cout: int, bn: int, cin: int, kc: int = 64) -> int:
    """Splits of K = 9 * Cin for the wgmma kernels: 1, or, where the output
    tiles fill under half of the card's SMs (the small deep maps, bound by
    their weight bytes), about one wave of blocks, each split a run of whole
    `kc`-channel slices (64 in bf16, 128 in int8) and none empty. The
    splits' partial sums (fp32, or int32 in int8) are added in a fixed
    order by a second kernel."""
    blocks = n_tiles * nb * (cout // bn)
    slices = -(-cin // kc)
    if 2 * blocks > SMS:
        return 1
    per = -(-slices // min(slices, -(-SMS // blocks)))
    return -(-slices // per)


def wide_config(nb: int, rows: int, width: int, cin: int, cout: int, quant: bool = False):
    """(tile rows, tile columns, output channels per block, splits of K)
    of the wgmma kernel (bf16, or int8 with `quant`: the same tiles, slices
    of 128 channels) for an (nb, rows, width, cin) -> cout call. 128-pixel
    tiles with `wide_bn` channels and `wide_split` splits; but where that
    tile's patch is too large for two blocks to share an SM (4 x 32 and
    2 x 64 tiles of 128 channels), 256-pixel tiles, if they still give
    nearly a wave of blocks: a weight slice read from L2 then feeds twice
    the products. (Where two 128-pixel blocks do share an SM, their overlap
    is worth more on the H100 than the halved weight traffic.)"""
    th, tw = wide_tile(rows, width)
    n_tiles = -(-rows // th) * -(-width // tw)
    bn = wide_bn(n_tiles, nb, cout)
    if bn == 128 and (th + 2) * (tw + 2) > TWO_PER_SM_PATCH:
        th2, tw2 = wide_tile(rows, width, 256)
        if -(-rows // th2) * -(-width // tw2) * nb * (cout // 128) >= SMS * 9 // 10:
            return th2, tw2, 128, 1
    return th, tw, bn, wide_split(n_tiles, nb, cout, bn, cin, WIDE_KC[quant])


def _lib():
    lib = _build.library("conv3x3")
    if lib.kdt_conv3x3.argtypes is None:
        lib.kdt_conv3x3.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        lib.kdt_conv3x3.restype = _I
        lib.kdt_conv3x3_int8.argtypes = [_P] * 9 + [_I] * 8 + [_P]
        lib.kdt_conv3x3_int8.restype = _I
    return lib


def _lib_wide():
    lib = _build.library("conv3x3_sm90")
    if lib.kdt_conv3x3_wide.argtypes is None:
        lib.kdt_conv3x3_wide.argtypes = [_P] * 8 + [_I] * 11 + [_P]
        lib.kdt_conv3x3_wide.restype = _I
        lib.kdt_conv3x3_wide_int8.argtypes = [_P] * 10 + [_I] * 11 + [_P]
        lib.kdt_conv3x3_wide_int8.restype = _I
    return lib


def _lib_narrow():
    lib = _build.library("conv3x3_narrow")
    if lib.kdt_conv3x3_narrow.argtypes is None:
        lib.kdt_conv3x3_narrow.argtypes = [_P] * 7 + [_I] * 10 + [_P]
        lib.kdt_conv3x3_narrow.restype = _I
        lib.kdt_conv3x3_narrow_in_plan.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.kdt_conv3x3_narrow_in_plan.restype = _I
    return lib


def narrow_in_plan(cin: int, cout: int) -> dict:
    """The narrow init conv's launch at (Cin, Cout), from the library: its
    dynamic shared memory, staging buffers, blocks an SM and tile pixels."""
    lib = _lib_narrow()
    plan = (_I * 4)()
    _build.check(lib, lib.kdt_conv3x3_narrow_in_plan(cin, cout, plan), "narrow init plan")
    return dict(smem_bytes=plan[0], staging_buffers=plan[1], blocks_per_sm=plan[2],
                tile_pixels=plan[3])


def conv3x3_cuda(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
                 pro: Optional[Tensor] = None, want_stats: bool = False,
                 chunks: int = 0, quant: bool = False, a_max: Optional[Tensor] = None,
                 want_range: bool = False, bias_in_dtype: bool = False,
                 w_q: Optional[QuantWeights] = None):
    """Launch the kernel `route` picks. bf16 activations and weights (or
    `w_q`), fp32 bias, prologue, stats and ranges; raises on anything else."""
    global LAUNCHES, LAUNCHES_WIDE, LAUNCHES_NARROW, LAUNCHES_INT8, LAUNCHES_INT8_WIDE
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
    if quant and bias_in_dtype:
        raise ValueError("bias_in_dtype is the plain conv's rounding; not with quant")
    dev = x.device
    if w.device != dev:
        raise ValueError(f"weights on {w.device}, activations on {dev}")
    x = _build.aligned(x)
    bias = b.to(device=dev, dtype=torch.float32).contiguous() if b is not None else None
    if pro is not None:
        if tuple(pro.shape) != (nb, 2, cin):
            raise ValueError(f"pro must be {(nb, 2, cin)}, got {tuple(pro.shape)}")
        pro = _build.aligned(pro.to(device=dev, dtype=torch.float32))
    kernel = route(cin, cout, quant, bias_in_dtype)
    if kernel in ("wgmma", "wgmma_int8"):
        th, tw, bn, ksplit = wide_config(nb, h, wd, cin, cout, quant)
    elif kernel == "narrow":
        th, tw = NARROW_OUT_TILE if cout <= NARROW_MAX_COUT else narrow_in_tile(h, wd, cout)
    else:
        tw = tile_w(wd)
        th = 64 // tw
    n_tiles = -(-wd // tw) * -(-h // th)
    y = torch.empty((nb, h, wd, cout), dtype=torch.bfloat16, device=dev)
    slots = lambda: torch.empty((nb, n_tiles, 2, cout), dtype=torch.float32, device=dev)  # noqa: E731
    partial = slots() if want_stats else None
    prange = slots() if want_range else None
    range_mode = (1 if want_stats else 2) if want_range else 0
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    if quant:
        # the scale of the prologue'd input; without a bound, its amax needs
        # the prologue'd tensor (only the dynamic-amax escape hatch gets here)
        xs = apply_prologue(x, pro) if (pro is not None and a_max is None) else x
        s_a = activation_scale(xs, None if a_max is None else a_max.to(dev)).reshape(1)
        w_q = w_q if w_q is not None else quantize_weights(w)
        wq, s_w = w_q[:2]
        if wq.dtype != torch.int8 or tuple(wq.shape) != tuple(w.shape) or wq.device != dev:
            raise ValueError(f"w_q must be int8 {tuple(w.shape)} on {dev}")
        sasw = (s_a * s_w.to(dev)).contiguous()
        if kernel == "wgmma_int8":
            wk = w_q[2] if len(w_q) > 2 else kmajor_weights(wq)
            if wk.dtype != torch.int8 or tuple(wk.shape) != (3, 3, cout, cin):
                raise ValueError(f"K-major w_q must be int8 {(3, 3, cout, cin)}")
            wk = _build.aligned(wk)
            ws = (torch.empty((ksplit, nb, h, wd, cout), dtype=torch.int32, device=dev)
                  if ksplit > 1 else None)
            lib = _lib_wide()
            rc = lib.kdt_conv3x3_wide_int8(
                ptr(x), ptr(wk), ptr(s_a), ptr(sasw), ptr(bias), ptr(pro), ptr(y), ptr(partial),
                ptr(prange), ptr(ws), nb, h, wd, cin, cout, int(chunks), th, tw, bn, ksplit,
                range_mode, stream)
            _build.check(lib, rc, "conv3x3 wgmma int8")
            LAUNCHES_INT8_WIDE += 1
        else:
            lib = _lib()
            rc = lib.kdt_conv3x3_int8(
                ptr(x), ptr(_build.aligned(wq)), ptr(s_a), ptr(sasw), ptr(bias), ptr(pro),
                ptr(y), ptr(partial), ptr(prange), nb, h, wd, cin, cout, int(chunks), tw,
                range_mode, stream)
            _build.check(lib, rc, "conv3x3 int8")
        LAUNCHES_INT8 += 1
    else:
        wb = _build.aligned(w.to(torch.bfloat16))
        if kernel == "wgmma":
            ws = (torch.empty((ksplit, nb, h, wd, cout), dtype=torch.float32, device=dev)
                  if ksplit > 1 else None)
            lib = _lib_wide()
            rc = lib.kdt_conv3x3_wide(
                ptr(x), ptr(wb), ptr(bias), ptr(pro), ptr(y), ptr(partial), ptr(prange),
                ptr(ws), nb, h, wd, cin, cout, int(chunks), th, tw, bn, ksplit, range_mode,
                stream)
            _build.check(lib, rc, "conv3x3 wgmma")
            LAUNCHES_WIDE += 1
        elif kernel == "narrow":
            lib = _lib_narrow()
            rc = lib.kdt_conv3x3_narrow(
                ptr(x), ptr(wb), ptr(bias), ptr(pro), ptr(y), ptr(partial), ptr(prange),
                nb, h, wd, cin, cout, int(chunks), th, tw, range_mode, int(bias_in_dtype),
                stream)
            _build.check(lib, rc, "conv3x3 narrow")
            LAUNCHES_NARROW += 1
        else:
            lib = _lib()
            rc = lib.kdt_conv3x3(
                ptr(x), ptr(wb), ptr(bias), ptr(pro), ptr(y), ptr(partial), ptr(prange),
                nb, h, wd, cin, cout, int(chunks), tw, range_mode, int(bias_in_dtype), stream)
            _build.check(lib, rc, "conv3x3")
        LAUNCHES += 1
    stats = ranges = None
    if want_stats:
        s = partial.sum(dim=1)  # per-tile slots, summed in a fixed order
        stats = finish_stats(s[:, 0], s[:, 1], h * wd, b)
    if want_range:
        rmax, rmin = prange[:, :, 0].amax(dim=1), prange[:, :, 1].amin(dim=1)
        if want_stats and bias is not None:
            rmax, rmin = rmax + bias, rmin + bias
        ranges = torch.stack([rmax, rmin], dim=1)
    return _finish(y, stats, ranges)


@contextlib.contextmanager
def full_fp32(device: torch.device):
    """fp32 convs and matmuls on the card without TF32 (cuDNN's fp32 convs
    use it by default), so a recompute computes the function it is defined
    as, as on the CPU. Nothing to change on the CPU."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Conv3x3Function(torch.autograd.Function):
    """`conv3x3` under autograd. `launch` is its forward (`conv3x3_cuda` on
    the card, `conv3x3_plain` on the CPU) and `opts` its keyword options;
    the backward is `_conv3x3_vjp`'s (see the module docstring). Returns
    the tuple `launch` returns, `(out,)` for a lone output."""

    @staticmethod
    def forward(ctx, launch, opts, x, w, b, pro, a_max, w_q):
        outs = launch(x, w, b, pro=pro, a_max=a_max, w_q=w_q, **opts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ctx.opts = opts
        ctx.save_for_backward(x, w, b, pro)
        if opts["want_range"]:
            ctx.mark_non_differentiable(outs[-1])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = [t is not None and n for t, n in zip(saved, ctx.needs_input_grad[2:6])]
        with torch.enable_grad(), full_fp32(saved[0].device):
            leaves = [None if t is None else t.detach().float().requires_grad_()
                      for t in saved]
            ref = conv3x3_plain(leaves[0], leaves[1], leaves[2], pro=leaves[3],
                                want_stats=ctx.opts["want_stats"], chunks=ctx.opts["chunks"])
            ref = ref if isinstance(ref, tuple) else (ref,)
            wrt = [leaf for leaf, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(ref, wrt, [g.float() for g in grads[:len(ref)]])
                       if wrt else ())
        out = [next(got).to(t.dtype) if n else None for t, n in zip(saved, need)]
        return (None, None, *out, None, None)


def conv3x3(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
            pro: Optional[Tensor] = None, want_stats: bool = False,
            chunks: int = 0, quant: bool = False, a_max: Optional[Tensor] = None,
            want_range: bool = False, bias_in_dtype: bool = False,
            w_q: Optional[QuantWeights] = None):
    """3x3 SAME conv over NHWC with optional fused silu-affine prologue,
    [sum, centered sumsq] stats and [max, min] range epilogues, and the w8a8
    int8 mode (see the module docstring). `w_q` is `quantize_weights(w)`,
    made once by a caller that reuses the weights.

    A tensor on the CPU runs the plain version; a tensor on the card runs
    the CUDA kernel or raises. While autograd records an input that needs
    a gradient, the same forward runs inside `Conv3x3Function`."""
    if x.device.type == "cpu":
        launch = conv3x3_plain
    elif x.device.type == "cuda":
        launch = conv3x3_cuda
    else:
        raise ValueError(f"conv3x3 runs on the CPU or a CUDA device, not {x.device}")
    opts = dict(want_stats=want_stats, chunks=chunks, quant=quant, want_range=want_range,
                bias_in_dtype=bias_in_dtype)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, b, pro)):
        outs = Conv3x3Function.apply(launch, opts, x, w, b, pro, a_max, w_q)
        return outs if len(outs) > 1 else outs[0]
    return launch(x, w, b, pro=pro, a_max=a_max, w_q=w_q, **opts)

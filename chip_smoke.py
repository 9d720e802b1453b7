#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kidney_diffusion_tpu_torch`) on one
NVIDIA card: the quickest proof that the port starts and is right there.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, each printing its own lines and seconds:

1. device: the card's name, the device count, and `nvidia-smi`'s name and
   power limit;
2. build: nvcc compiles every kernel of the main path (`kernels/csrc/*.cu`,
   sm_90a, plain C interface, loaded with ctypes), all in parallel, and
   prints each kernel's registers and spills (the narrow init conv's 16
   instantiations, one per Cin, must not spill);
3. kernels: each kernel's wrapper on card tensors at the flagship shapes,
   held against its plain PyTorch version on the same inputs with the
   stated tolerances, and timed beside the plain version and one PyTorch
   library call as a yardstick (device time per call: the calls are
   captured in a CUDA graph and replayed, timed by CUDA events; the
   wrapper's eager time, host launch cost included, is printed beside it):
   conv3x3 in bf16 on the kernel `conv3x3.route` picks (the wgmma kernel
   for the wide convs, the narrow kernel for the init convs, Cin 3-12 as
   the served configs call them, and the final convs), each case also on
   the WMMA kernel through a forced route (held against
   the plain version there too, and timed), with its range epilogue and
   bf16-bias rounding; in its int8 mode on the wgmma int8 kernel, each case
   also on the WMMA int8 mode and, as a bf16 reference (not a library
   call), on the bf16 wgmma kernel at the same shape; and attention;
   `F.conv2d` is timed on NCHW and on channels-last bf16, and the faster is
   the yardstick;
4. probe: the int8 tap-product probe's three kernels against their plain
   versions, then its entry point (`tools.probe_int8.run`) at REPS
   back-to-back launches per variant, with bounds and one-call yardsticks;
5. forward: a full-width stage-1 U-Net forward through the kernels on the
   card against the plain path on the CPU, same weights and inputs; then
   the full-width stage-3 U-Net with the int8 + fp8 serving overrides at
   the 256² training crop, the same way, with the spreads of its exact and
   int8-only variants (and of the int8 + fp8 forward with every conv on
   the WMMA kernel) beside it, and once more with float8_e5m2 storage
   (after a check that the card's e5m2 cast and amax equal the CPU's),
   held to its own stated tolerance;
6. serve: the flagship `ultra_res(0, "v_param")` cascade at full width,
   weights made on the card from --seed, answers (A) one 1024² patch at the
   shipped serving mix dpmpp_steps=(25, 25, 0), ddim_steps=(0, 0, 4),
   (B) a batch of 2 from stage 1 alone on its ancestral loop cut to 8 steps,
   and (C) request A's patch with the shipped serving overrides
   (`serving_overrides(quant="int8", storage="float8_e4m3fn")`: stage 3 on
   w8a8 int8 convs with fp8 activation storage), through `Cascade.sample`.
   Launch counts are zeroed just before each request and read just after;
   they must equal one launch per 3x3 conv (bf16 or int8 as
   `_quant_site` gates it, each on the kernel `conv3x3.route` picks: none
   on the WMMA kernel) and per attention layer of every U-Net forward, so
   every such layer of the path ran its kernel. A and C are then run again
   under torch.profiler for their device busy time;
7. gigapixel: (G) one whole mag-1 level of `ultra_res(1, "v_param")` at
   full width, as `cli/sample_ultra_res.py` serves it (int8 + fp8 stage 3,
   the resident transport) at the serving mix, weights drawn from --seed on
   the card, request C's patch as the mag-0 image: 64 patches of an 8 x 8
   grid in 15 waves, stitched into a 6400² canvas. It requires 64 uint8
   1024² patches with finite U-Net outputs, every overlap band equal to its
   generated neighbour's pixels, the canvas equal to the patches pasted on
   the upscaled coarse image, and launches per kernel equal to the layers
   of every forward (none on the WMMA kernel: the Cin-9 init convs of
   stages 2 and 3 on the narrow kernel); it prints the level's wall and patches/s, per stage
   wall, device span (CUDA events around each `sample_stage` call), mean
   batch and, from its largest chunk run again, device busy time (profiled),
   idle share and the cost of building the stage model per call; host
   seconds in prep and model building, the seconds of the synchronous
   copies of final patches to the host, peak memory. (G') the first four
   patches on the uint8 wire and on the resident transport from one seed:
   every chunk's conditioning inputs equal (strips within one count at
   coarse-fallback pixels). (M2) the mag-2 tissue mask of G's canvas on
   the card equal to the CPU's, the filter's count, and four mag-2 patches
   (`all_patches`) from G's weights;
8. train: the flagship's training half through `Trainer.train_step`, set
   up as `cli/train_ultra_res.py` sets it up (Adam lr 1e-4, betas (0.9,
   0.99), eps 1e-8, EMA 0.9999, `max_grad_norm=1.0`, batch 8): first one
   stage-3 loss and gradient at full width (B=1, the 256² crop of a 1024²
   image), with weights drawn from --seed with no zero-initialised layer, on
   the card against the CPU plain path with the same draws (GRAD_TOL,
   LOSS_TOL; every parameter's gradient finite and non-zero); then, from the
   trainer's own initial state, five stage-3 steps at B=8 on one batch with
   fixed draws (finite losses, the last below the
   first, 5 steps taken, an EMA leaf equal to the warmup formula, each step's
   launches per kernel equal to the forward's sites at the crop), two stage-1
   steps at B=8 (finite gradients, launches incl. self-attention), and a
   save / load of stage 3's state (full, and `ema_only` with `partial=True`)
   bit-equal; ms per step by CUDA events, the backward's share, peak memory,
   and device busy time and idle share from a profiled extra step;
9. with `--profile` only (after serve): requests A and C again stage by
   stage under torch.profiler (device busy time, idle share, top kernels).

Then one JSON line with every kernel's numbers, the `nvidia-smi` line, and
last `{"ok": true, "device": {...}}`. Any failed check raises, so the script
exits non-zero and prints no result; without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from kidney_diffusion_tpu_torch.cascade import Cascade, stage_sampler_steps
from kidney_diffusion_tpu_torch.convert import build_model, init_stage_params
from kidney_diffusion_tpu_torch.kernels import _build
from kidney_diffusion_tpu_torch.kernels import attention as attn_mod
from kidney_diffusion_tpu_torch.kernels import conv3x3 as conv_mod
from kidney_diffusion_tpu_torch.models.blocks import (
    Conv3x3,
    CrossAttention,
    SelfAttention,
    _quant_site,
    dynamic_amax,
)
from kidney_diffusion_tpu_torch.models.configs import serving_overrides, ultra_res
from kidney_diffusion_tpu_torch.models.unet import EfficientUNet, cast_storage
from kidney_diffusion_tpu_torch.ops.image import foreground_mask_for_patches
from kidney_diffusion_tpu_torch.sample import gigapixel as gp
from kidney_diffusion_tpu_torch.sample.resident import ResidentEngine
from kidney_diffusion_tpu_torch.sample.wavefront import (
    bucket_size,
    choose_orientation,
    plan_waves,
)
from kidney_diffusion_tpu_torch.tools import probe_int8
from kidney_diffusion_tpu_torch.train import Trainer
from kidney_diffusion_tpu_torch.train.optim import ema_decay
from kidney_diffusion_tpu_torch.utils.checkpoint import flatten

# request A: the shipped serving mix; (stage, sampler steps = U-Net forwards)
SERVE_A = dict(dpmpp_steps=(25, 25, 0), ddim_steps=(0, 0, 4))
FORWARDS_A = ((1, 25), (2, 25), (3, 4))

# request G: one mag-1 level of ultra_res(1, "v_param") as the CLI serves it
# (resident wire, int8 + fp8 stage 3) at the shipped serving mix
GIGA = dict(overlap=0.25, inpaint_resample_times=1, max_wave_batch=32, **SERVE_A)
GIGA_PATCHES = 64  # the whole 8 x 8 grid of a 1024² mag-0 image
GIGA_WIRE_PATCHES = 4  # G' and M2: the first four patches (row 0)
# G's launches of the narrow kernel (every init and final conv of its 1006
# forwards: 1381 of Cin 6 and Cout 3, 631 Cin-9 init convs of stages 2-3)
# and of the WMMA kernel (none: no site of a served config is ragged)
GIGA_NARROW_LAUNCHES = 2012
GIGA_WMMA_LAUNCHES = 0

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
BF16_ULP = 2.0**-7  # spacing of bf16 values in [1, 2)

CONV_SOURCE = "kidney_diffusion_tpu_torch/kernels/csrc/conv3x3.cu"
WIDE_SOURCE = "kidney_diffusion_tpu_torch/kernels/csrc/conv3x3_sm90.cu"
NARROW_SOURCE = "kidney_diffusion_tpu_torch/kernels/csrc/conv3x3_narrow.cu"
CONV_REPLACES = "kidney_diffusion_tpu/kernels/conv3x3.py:394"
# the int8 mode: a mode of the conv kernels; on the TPU the int8 conv ran in
# XLA (`_int8_conv`), the Pallas conv being the kernel it extends
CONV_INT8_REPLACES = "kidney_diffusion_tpu/kernels/conv3x3.py:394"
ATTN_SOURCE = "kidney_diffusion_tpu_torch/kernels/csrc/attention.cu"
ATTN_REPLACES = "kidney_diffusion_tpu/kernels/attention.py:68"
PROBE_SOURCE = "kidney_diffusion_tpu_torch/kernels/csrc/probe_int8.cu"
PROBE_REPLACES = "tools/probe_int8_pallas.py:74"
# launches of requests A and C per conv kernel (a cross-check of
# `expected_launches`): the wide 3x3 convs of the three U-Nets (73, 58 and
# 106 a forward) times each stage's forwards, less C's int8 stage 3, on the
# wgmma kernel; the init and final convs (2 a forward) on the narrow
# kernel; C's 424 int8 convs on the wgmma int8 kernel; none on the WMMA one
WIDE_LAUNCHES = {"A": 3699, "C": 3275}
NARROW_LAUNCHES = {"A": 108, "C": 108}
INT8_WIDE_LAUNCHES = {"A": 0, "C": 424}

# name: (batch*chunks, rows, width, cin, cout, chunks, prologue, stats)
CONV_CASES = {
    "a_stage3_chunked_512": (16, 32, 512, 128, 128, 16, True, True),
    "c_stage1_16x16_768": (1, 16, 16, 768, 768, 0, True, True),
    "e_stage3_skip_concat_64": (16, 4, 64, 2048, 1024, 16, True, True),
    # what the wgmma kernel can get wrong: item boundaries of an unchunked
    # batch must read zero rows; maps smaller than one 128-pixel tile
    "g_unchunked_batch2_64_256": (2, 64, 64, 256, 256, 0, True, True),
    "h_deep_4x4_1024": (2, 4, 4, 1024, 1024, 0, False, False),
    "i_stage1_skip_concat_8x8": (2, 8, 8, 2048, 1024, 0, True, True),
}
# the narrow ends (the narrow kernel), as the U-Nets call them: name:
# (batch*chunks, rows, width, cin, cout, chunks, prologue, stats, range,
# bias_in_dtype)
NARROW_CASES = {
    "d_stage3_final_conv": (16, 64, 1024, 128, 3, 16, False, False, False, False),
    "b_stage3_init_conv": (16, 64, 1024, 6, 128, 16, False, False, False, False),
    "b_range": (16, 64, 1024, 6, 128, 16, False, False, True, False),  # request C's call
    "f_stage1_init_conv_bias_in_dtype": (1, 64, 64, 3, 256, 0, False, False, False, True),
    "j_stage1_final_conv": (1, 64, 64, 256, 3, 0, False, False, False, False),
    "k_stage2_init_conv_bias_in_dtype": (1, 256, 256, 6, 128, 0, False, False, False, True),
    "l_stage2_final_conv": (1, 256, 256, 128, 3, 0, False, False, False, False),
    # stage 1 of a magnification level above 0 (Cin = 3 + 3 cond) in the
    # level's wave chunks of up to 8
    "v_stage1_init_conv_cin6_batch8_bias_in_dtype": (8, 64, 64, 6, 256, 0, False, False, False,
                                                     True),
    # the init convs of stages 2 and 3 at magnification levels above 0 (Cin
    # = 3 + 3 low-res + 3 cond = 9), as the gigapixel level calls them
    # (stage 3 int8-served, so with its range)
    "t_stage3_init_conv_cin9_range": (16, 64, 1024, 9, 128, 16, False, False, True, False),
    "u_stage2_init_conv_cin9_bias_in_dtype": (1, 256, 256, 9, 128, 0, False, False, False, True),
    "w_stage2_init_conv_cin9_batch8_bias_in_dtype": (8, 256, 256, 9, 128, 0, False, False, False,
                                                     True),
    # v2 at mag > 0 (6 cond channels: Cin 12 at stages 2-3, 9 at stage 1)
    # and patch_conditioned (a 4-channel labelmap: Cin 10 at stages 2-3)
    "x_v2_stage2_init_conv_cin12_bias_in_dtype": (1, 256, 256, 12, 128, 0, False, False, False,
                                                  True),
    "y_v2_stage3_init_conv_cin12_range": (16, 64, 1024, 12, 128, 16, False, False, True, False),
    "z_patch_conditioned_stage2_init_conv_cin10_bias_in_dtype": (1, 256, 256, 10, 128, 0, False,
                                                                 False, False, True),
    "aa_v2_stage1_init_conv_cin9_batch8_bias_in_dtype": (8, 64, 64, 9, 256, 0, False, False,
                                                         False, True),
}
# the WMMA kernel's row in the kernels line leads with the shape it served
# on the gigapixel path before the narrow kernel took Cin up to 16
WMMA_HEAD = "t_stage3_init_conv_cin9_range"
# bf16 mode, serving-path options on the shapes above, and what the narrow
# kernel can get wrong (prologue, stats and range at ragged maps: partial
# tiles, rows not a whole number of 16-byte stores, chunk halos):
# name: (batch*chunks, rows, width, cin, cout, chunks, prologue, stats, range, bias_in_dtype)
CONV_OPTION_CASES = {
    "a_range": (16, 32, 512, 128, 128, 16, True, True, True, False),
    "c_bias_in_dtype": (1, 16, 16, 768, 768, 0, True, True, False, True),
    "m_final_ragged_pro_stats_range": (4, 7, 130, 192, 3, 2, True, True, True, False),
    "n_final_bias_in_dtype_range": (2, 9, 70, 64, 5, 0, False, False, True, True),
    "o_init_ragged_pro_stats_range": (4, 5, 37, 3, 256, 2, True, True, True, False),
    "p_init_cin8_pro_stats_range": (2, 9, 20, 8, 192, 0, True, True, True, False),
    "o9_init_cin9_ragged_pro_stats_range": (4, 5, 37, 9, 256, 2, True, True, True, False),
    "p12_init_cin12_pro_stats_range": (2, 9, 20, 12, 192, 0, True, True, True, False),
    # the range of the staged bf16 output (no stats) on partial tiles and
    # chunk halos; Cout 512 (tiles of 32 pixels, one block an SM) at Cin 16
    "o12_init_cin12_ragged_pro_range": (4, 7, 40, 12, 128, 2, True, False, True, False),
    "r_init_cin16_cout512_range": (2, 6, 40, 16, 512, 0, False, False, True, False),
    "t_stage3_init_conv_cin9": (16, 64, 1024, 9, 128, 16, False, False, False, False),
}
# every Cin the narrow init conv takes (one instantiation each), on a small
# ragged map with prologue, stats and range
CONV_OPTION_CASES.update({f"q_init_cin{c}_pro_stats_range": (2, 6, 20, c, 64, 0, True, True, True,
                                                             False) for c in range(1, 17)})
# int8 mode at the flagship stage-3 shapes; a_max "bound" = a given bound,
# None = dynamic amax: name: (batch*chunks, rows, width, cin, cout, chunks,
# prologue, stats, range, a_max)
INT8_CASES = {
    "a_stage3_chunked_512_int8": (16, 32, 512, 128, 128, 16, True, True, True, "bound"),
    "a_dynamic_amax_int8": (16, 32, 512, 128, 128, 16, True, True, True, None),
    "e_skip_concat_64_int8": (16, 4, 64, 2048, 1024, 16, True, True, True, "bound"),
    "g_unchunked_64_int8": (2, 64, 64, 256, 256, 0, False, True, True, "bound"),
    "h_upsample_1024_int8": (16, 64, 1024, 128, 128, 16, False, False, True, "bound"),
    # what the wgmma int8 kernel can get wrong: deep maps split over K (int32
    # partials; no stage-3 int8 site splits: 16 chunks fill the card), and a
    # Cin that ends in a half slice of 64 channels
    "q_split_4x4_1024_int8": (2, 4, 4, 1024, 1024, 0, False, True, True, "bound"),
    "r_split_16x16_768_int8": (1, 16, 16, 768, 768, 0, True, True, True, "bound"),
    "s_half_slice_192_int8": (2, 32, 32, 192, 128, 0, False, True, True, "bound"),
}
# name: (batch, nq, nk, heads, dim_head)
ATTN_CASES = {
    "self_1024_plus_2": (1, 1024, 1026, 8, 64),
    "cross_4096_4": (1, 4096, 4, 8, 64),
    "ragged_1000_2": (1, 1000, 2, 8, 64),  # Nq not a multiple of the 64-query tile
    "head32_1024_plus_2": (1, 1024, 1026, 8, 32),
}
# output: normwise relative error <= 2^-8 (a bf16 rounding unit; most elements
# round identically, a few flip by one ulp) and max abs error <= 2 bf16 ulps
# of the largest value; stats (fp32): 1e-4 normwise, 1e-3 of the largest
CONV_TOL = {"y": (2 * BF16_ULP, 2.0**-8), "stats": (1e-3, 1e-4)}
# the kernel rounds exp(s - running max) to bf16 where the plain version
# rounds the normalised weights: 4 ulps of the largest value, 2^-7 normwise
ATTN_TOL = (4 * BF16_ULP, 2.0**-7)
# the full-width forward compounds one-ulp rounding flips over ~100 layers
FORWARD_TOL = (0.25, 2.0**-4)
# the int8 + fp8 forward: int8 rounding turns a one-ulp bf16 flip near a
# quantization boundary into a whole int8 step, and fp8 storage keeps 3
# mantissa bits (the JAX package's own jitted and eager runs of a tiny int8 +
# fp8 U-Net differ by 0.105 normwise); max abs err <= the largest value,
# 2^-3 normwise
QUANT_FORWARD_TOL = (1.0, 2.0**-3)
# the same forward with float8_e5m2 storage: 2 mantissa bits, so each
# stored map rounds twice as coarsely and a flip moves it twice as far.
# The JAX package's own jitted and eager runs of the tiny int8 + e5m2 U-Net
# (chunks 4) differ by 0.189 normwise, 1.8 x their e4m3fn spread (0.105):
# max abs err <= the largest value, 2^-2 normwise (2 x QUANT_FORWARD_TOL's)
QUANT_FORWARD_TOL_E5M2 = (1.0, 2.0**-2)
# the train phase's gradient check, card against the CPU plain path at full
# width: normwise over every parameter's gradient together no looser than
# FORWARD_TOL's 2^-4 (the forward's one-ulp flips, carried through the
# backward), and the loss within 2^-5 relative
GRAD_TOL = 2.0**-4
LOSS_TOL = 2.0**-5
# the CLI's training set-up (`cli/train_ultra_res.py:42`, `:61-66`)
TRAIN_BATCH = 8
TRAIN_STEPS = {3: 5, 1: 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    """A check of this run; it raises (also under `python -O`)."""
    if not ok:
        raise AssertionError(what)


def check(name: str, got, ref, tol) -> float:
    """Print and enforce the two tolerances: max abs err <= tol[0] * max|ref|
    (so max rel err = max abs err / max|ref| <= tol[0]) and normwise
    relative err ||got - ref|| / ||ref|| <= tol[1]. Returns the max abs err."""
    got, ref = got.double(), ref.double()
    diff = (got - ref).abs()
    scale = ref.abs().max().item()
    abs_err = diff.max().item()
    rel_err = abs_err / max(scale, 1e-30)
    norm_err = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    ok = rel_err <= tol[0] and norm_err <= tol[1] and torch.isfinite(got).all().item()
    log(f"  {name}: max_abs_err={abs_err:.3e} (tol {tol[0] * scale:.3e}) "
        f"max_rel_err={rel_err:.2e} (tol {tol[0]:.2e}, relative to max|ref|={scale:.3g}) "
        f"normwise_rel_err={norm_err:.2e} (tol {tol[1]:.2e}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return abs_err


def eager_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of `iters` back-to-back calls from the
    host, by CUDA events, after a warm-up: the host's launch cost included
    wherever it is longer than the device's work."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call: `iters` calls captured in one CUDA
    graph after a warm-up, the graph replayed once to warm it and once
    timed by CUDA events, so the host's launch cost is not counted."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require_equal(name: str, got, ref) -> float:
    """Bit-equality of a kernel's output with its plain version's."""
    n_diff = (got != ref).sum().item()
    log(f"  {name}: bit-equal {n_diff == 0} ({n_diff} of {got.numel()} elements differ)")
    require(n_diff == 0, f"{name}: kernel output is not bit-equal to its plain version")
    return 0.0


def check_range_of_output(name: str, out, ranges) -> None:
    """A range epilogue's [max, min], rounded to bf16, must be exactly the
    output's own per-channel max and min (rounding is monotone)."""
    ok = (torch.equal(ranges[:, 0].bfloat16(), out.amax(dim=(1, 2)))
          and torch.equal(ranges[:, 1].bfloat16(), out.amin(dim=(1, 2))))
    log(f"  {name}: range == [max, min] of its own output: {ok}")
    require(ok, f"{name}: range epilogue disagrees with the output")


@contextlib.contextmanager
def wmma_only():
    """Every bf16 conv on the WMMA kernel, the wide convs' kernel before the
    wgmma one: a comparison inside this run, not a path of the port."""
    routed = conv_mod.route
    conv_mod.route = lambda *args, **kwargs: "wmma"
    try:
        yield
    finally:
        conv_mod.route = routed


def conv_inputs(gen, nb, h, w, cin, cout, chunks, pro):
    dev = torch.device("cuda")
    x = torch.randn((nb, h, w, cin), generator=gen, device=dev).bfloat16()
    wk = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) / (9 * cin) ** 0.5).bfloat16()
    b = torch.randn((cout,), generator=gen, device=dev)
    p = None
    if pro:  # per-image affine repeated over its chunks, as GroupNorm makes it
        n_img = nb // max(chunks, 1)
        p = torch.randn((n_img, 2, cin), generator=gen, device=dev)
        p[:, 0] = p[:, 0].abs() + 0.5
        p = p.repeat_interleave(max(chunks, 1), dim=0)
    return x, wk, b, p


def phase_device():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] {time.perf_counter() - t0:.1f} s")
    return name, count, smi


def ptxas_kernels(report: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in nvcc's `-Xptxas -v` report."""
    out, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spills))
            name = None
    return out


def phase_build():
    t0 = time.perf_counter()
    seconds = _build.build(["conv3x3", "conv3x3_sm90", "conv3x3_narrow", "attention",
                            "probe_int8"])
    for name, report in _build.PTXAS_REPORTS.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    # the narrow init conv, one instantiation per Cin: registers and spills
    init = [(int(re.search(r"conv3x3_narrow_inILi(\d+)E", k).group(1)), r, ss, sl)
            for k, r, ss, sl in ptxas_kernels(_build.PTXAS_REPORTS.get("conv3x3_narrow", ""))
            if "conv3x3_narrow_inILi" in k]
    for cin, regs, ss, sl in sorted(init):
        log(f"[build] conv3x3_narrow_in<{cin}>: {regs} registers, {ss} bytes spill stores, "
            f"{sl} bytes spill loads")
    require(not _build.PTXAS_REPORTS.get("conv3x3_narrow") or len(init) == 16,
            f"conv3x3_narrow_in instantiations in the report: {sorted(init)}")
    require(all(ss == sl == 0 for _, _, ss, sl in init), f"narrow init conv spills: {init}")
    # load the libraries through ctypes
    conv_mod._lib(), conv_mod._lib_wide(), conv_mod._lib_narrow(), attn_mod._lib()
    probe_int8._lib()
    log(f"[build] nvcc sm_90a -> ctypes: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    log(f"[build] {time.perf_counter() - t0:.1f} s")


def conv_library_ms(x, wk, b, nb, chunks, iters):
    """`F.conv2d` on the unchunked image in bf16, NCHW and channels-last."""
    h, w, cin = x.shape[1:]
    full_h = h * max(chunks, 1)
    xl = x.reshape(nb // max(chunks, 1), full_h, w, cin).permute(0, 3, 1, 2).contiguous()
    wl = wk.permute(3, 2, 0, 1).contiguous()
    xcl, wcl = (t.contiguous(memory_format=torch.channels_last) for t in (xl, wl))
    nchw = time_ms(lambda: F.conv2d(xl, wl, b.bfloat16(), padding=1), iters)
    nhwc = time_ms(lambda: F.conv2d(xcl, wcl, b.bfloat16(), padding=1), iters)
    return nchw, nhwc


def check_conv(label, got, ref, stats, rng_) -> float:
    """A bf16 conv's outputs against the plain version's: y (and stats,
    range) within CONV_TOL; the range also exactly that of its own output."""
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    err = check(f"y{label}", got[0].float(), ref[0].float(), CONV_TOL["y"])
    if stats:
        check(f"stats{label}", got[1], ref[1], CONV_TOL["stats"])
    if rng_:
        check(f"range{label}", got[-1], ref[-1], CONV_TOL["y"])
        check_range_of_output(f"range{label}", got[0], got[-1])
    return err


def phase_kernels(gen):
    """Every kernel against its plain version at the flagship shapes."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False  # the plain versions run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    # conv cases go to the row of the kernel that served them
    rows = {"conv3x3_wide": [], "conv3x3_narrow": [], "conv3x3": [], "conv3x3_int8_wide": [],
            "conv3x3_int8": [], "attention": []}
    conv_row = {"wgmma": "conv3x3_wide", "narrow": "conv3x3_narrow", "wmma": "conv3x3"}

    bf16_cases = {k: v + (False, False) for k, v in CONV_CASES.items()}
    bf16_cases.update(NARROW_CASES)
    timed = set(CONV_CASES) | set(NARROW_CASES)
    bf16_cases.update(CONV_OPTION_CASES)
    for case, (nb, h, w, cin, cout, chunks, pro, stats, rng_, bid) in bf16_cases.items():
        x, wk, b, p = conv_inputs(gen, nb, h, w, cin, cout, chunks, pro)
        kw = dict(pro=p, want_stats=stats, chunks=chunks, want_range=rng_, bias_in_dtype=bid)
        kernel = conv_mod.route(cin, cout, False, bid)
        forced = kernel != "wmma"  # else the route is the WMMA kernel already
        got = conv_mod.conv3x3(x, wk, b, **kw)
        ref = conv_mod.conv3x3_plain(x, wk, b, **kw)
        with wmma_only():  # the same call on the WMMA kernel, held to the same tolerances
            got_wmma = conv_mod.conv3x3(x, wk, b, **kw) if forced else got
        torch.cuda.synchronize()
        log(f"[kernels] conv3x3 {case}: x {tuple(x.shape)} -> {cout}, chunks={chunks}, "
            f"prologue={pro}, stats={stats}, range={rng_}, bias_in_dtype={bid}, kernel={kernel}")
        err = check_conv("", got, ref, stats, rng_)
        wmma_err = check_conv(" (WMMA kernel)", got_wmma, ref, stats, rng_) if forced else err
        row = dict(case=case, kernel=kernel, max_abs_err=err)
        if kernel == "narrow" and cout > conv_mod.NARROW_MAX_COUT:  # the init conv's launch
            row.update(conv_mod.narrow_in_plan(cin, cout))
            row["tile"] = conv_mod.narrow_in_tile(h, w, cout)
            log(f"  narrow init launch: tile {row['tile']}, {row['smem_bytes']} B shared memory, "
                f"{row['staging_buffers']} staging buffers, {row['blocks_per_sm']} blocks an SM")
        wmma_row = dict(case=case, kernel="wmma", max_abs_err=wmma_err, forced_route=True)
        if case in timed:
            iters = 20 if nb * h * w * cin * cout > 1e9 else 50
            ms = time_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
            with wmma_only():
                wmma_ms = (time_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
                           if forced else ms)
            row.update(ms=ms, wmma_ms=wmma_ms)
            if kernel == "wgmma":  # its tiling
                row["tile_h"], row["tile_w"], row["bn"], row["ksplit"] = conv_mod.wide_config(
                    nb, h, w, cin, cout)
            row["eager_ms"] = eager_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
            row["plain_ms"] = time_ms(lambda: conv_mod.conv3x3_plain(x, wk, b, **kw), iters)
            row["library_nchw_ms"], row["library_nhwc_ms"] = conv_library_ms(
                x, wk, b, nb, chunks, iters)
            row["library_ms"] = min(row["library_nchw_ms"], row["library_nhwc_ms"])
            n_ops = 2.0 * nb * h * w * 9 * cin * cout
            n_bytes = 2.0 * (x.numel() + wk.numel() + nb * h * w * cout) + 4.0 * cout
            n_bytes += (4.0 * (p.numel() if p is not None else 0)
                        + 8.0 * nb * cout * (stats + rng_))
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops)
            row["tflops"] = n_ops / ms / 1e9
            log(("  tile {tile_h}x{tile_w} bn {bn} ksplit {ksplit}".format(**row)
                 if kernel == "wgmma" else "")
                + f"  ms={ms:.4f} ({row['tflops']:.1f} TFLOP/s, {row['bound_ms'] / ms:.3f} of "
                f"the bound) eager_ms={row['eager_ms']:.4f} wmma_ms={wmma_ms:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms(F.conv2d bf16: NCHW "
                f"{row['library_nchw_ms']:.4f}, channels-last {row['library_nhwc_ms']:.4f}) "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
            wmma_row.update({k: v for k, v in row.items()
                             if k in ("plain_ms", "library_ms", "bound_ms", "bound_by")},
                            ms=wmma_ms)
        rows[conv_row[kernel]].append(row)
        if forced:
            rows["conv3x3"].append(wmma_row)

    for case, (nb, h, w, cin, cout, chunks, pro, stats, rng_, am) in INT8_CASES.items():
        x, wk, b, p = conv_inputs(gen, nb, h, w, cin, cout, chunks, pro)
        xin = conv_mod.apply_prologue(x, p) if pro else x
        # a true bound a little above the input's amax, as range propagation gives
        a_max = (1.25 * xin.float().abs().amax()) if am == "bound" else None
        w_q = conv_mod.quantize_weights(wk)
        w_q = w_q + (conv_mod.kmajor_weights(w_q[0]),)  # as `Conv3x3.quantized_weights` caches
        kw = dict(pro=p, want_stats=stats, chunks=chunks, quant=True, a_max=a_max,
                  want_range=rng_, w_q=w_q)
        kernel = conv_mod.route(cin, cout, True)
        got = conv_mod.conv3x3(x, wk, b, **kw)
        ref = conv_mod.conv3x3_plain(x, wk, b, **kw)
        with wmma_only():
            got_wmma = conv_mod.conv3x3(x, wk, b, **kw)
        torch.cuda.synchronize()
        log(f"[kernels] conv3x3 int8 {case}: x {tuple(x.shape)} -> {cout}, chunks={chunks}, "
            f"prologue={pro}, stats={stats}, range={rng_}, a_max={am or 'dynamic'}, "
            f"kernel={kernel}, tiling {conv_mod.wide_config(nb, h, w, cin, cout, True)}")
        errs = []
        for label, g in (("", got), (" (WMMA int8 mode)", got_wmma)):
            g, r = (g, ref) if isinstance(g, tuple) else ((g,), (ref,))
            if pro:  # the prologue's silu may round differently: CONV_TOL
                errs.append(check(f"y{label}", g[0].float(), r[0].float(), CONV_TOL["y"]))
                if rng_:
                    check(f"range{label}", g[-1], r[-1], CONV_TOL["y"])
            else:  # exact int32 sums, the same scales, the same rounding steps
                errs.append(require_equal(f"y{label}", g[0], r[0]))
                if rng_:
                    require_equal(f"range{label}", g[-1], r[-1])
            if stats:
                check(f"stats{label}", g[1], r[1], CONV_TOL["stats"])
            if rng_:
                check_range_of_output(f"range{label}", g[0], g[-1])
        iters = 20 if nb * h * w * cin * cout > 1e9 else 50
        ms = time_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
        e_ms = eager_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
        with wmma_only():
            wmma_ms = time_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
        bkw = dict(pro=p, want_stats=stats, chunks=chunks, want_range=rng_)
        bf16_ms = time_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **bkw), iters)
        plain_ms = time_ms(lambda: conv_mod.conv3x3_plain(x, wk, b, **kw), iters)
        n_ops = 2.0 * nb * h * w * 9 * cin * cout
        n_bytes = 2.0 * (x.numel() + nb * h * w * cout) + 1.0 * wk.numel() + 4.0 * cout
        n_bytes += 4.0 * (p.numel() if p is not None else 0) + 8.0 * nb * cout * (stats + rng_)
        bms, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
        log(f"  ms={ms:.4f} ({n_ops / ms / 1e9:.1f} TOP/s, {bms / ms:.3f} of the bound) "
            f"eager_ms={e_ms:.4f} wmma_int8_ms={wmma_ms:.4f} bf16_wgmma_ms(reference, "
            f"not a library call)={bf16_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=none (no int8 conv in PyTorch on CUDA) bound_ms={bms:.4f} ({by})")
        common = dict(case=case, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
        rows["conv3x3_int8_wide"].append(dict(
            common, kernel=kernel, max_abs_err=errs[0], ms=ms, eager_ms=e_ms,
            wmma_int8_ms=wmma_ms, bf16_wgmma_ms=bf16_ms))
        rows["conv3x3_int8"].append(dict(common, kernel="wmma", max_abs_err=errs[1], ms=wmma_ms,
                                         forced_route=True))

    for case, (b, nq, nk, hh, d) in ATTN_CASES.items():
        q, k, v = (torch.randn((b, n, hh, d), generator=gen, device=dev).bfloat16()
                   for n in (nq, nk, nk))
        got = attn_mod.attention(q, k, v)
        ref = attn_mod.attention_plain(q, k, v)
        torch.cuda.synchronize()
        log(f"[kernels] attention {case}: q {tuple(q.shape)} k/v {tuple(k.shape)}")
        err = check("o", got.float(), ref.float(), ATTN_TOL)
        ms = time_ms(lambda: attn_mod.attention_cuda(q, k, v), 50)
        e_ms = eager_ms(lambda: attn_mod.attention_cuda(q, k, v), 50)
        plain_ms = time_ms(lambda: attn_mod.attention_plain(q, k, v), 50)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), 50)
        lib_eager = eager_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), 50)
        if case == "self_1024_plus_2":  # which kernel the yardstick is
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                F.scaled_dot_product_attention(qs, ks, vs)
                torch.cuda.synchronize()
            kernels, _ = kernel_times(prof)
            log("  sdpa ran: " + "; ".join(e.key[:100] for e in kernels))
        n_ops = 4.0 * b * hh * nq * nk * d
        n_bytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bms, by = bound_ms(n_bytes, n_ops)
        log(f"  ms={ms:.4f} eager_ms={e_ms:.4f} plain_ms={plain_ms:.4f} library_ms(sdpa)="
            f"{lib_ms:.4f} (eager {lib_eager:.4f}) bound_ms={bms:.4f} ({by})")
        rows["attention"].append(dict(case=case, max_abs_err=err, ms=ms, eager_ms=e_ms,
                                      plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                      library_ms=lib_ms, library_eager_ms=lib_eager))
    log(f"[kernels] {time.perf_counter() - t0:.1f} s")
    return rows


def phase_probe():
    """The int8 tap-product probe: each variant's kernel against its plain
    version, then the probe's own entry point timed at REPS launches."""
    t0 = time.perf_counter()
    inputs = probe_int8.make_inputs("cuda")
    m, k, n, taps = probe_int8.M, probe_int8.K, probe_int8.N, probe_int8.TAPS
    n_ops = probe_int8.ops_per_call()
    errs = {}
    for variant in probe_int8.VARIANTS:
        args = inputs[variant]
        got = probe_int8.probe(variant, *args)
        ref = probe_int8.probe_plain(variant, *args)
        torch.cuda.synchronize()
        log(f"[probe] {variant}: x {tuple(args[0].shape)} {args[0].dtype}, "
            f"w {tuple(args[1].shape)} {args[1].dtype}")
        if variant == "bf16_dot":
            errs[variant] = check("o", got.float(), ref.float(), CONV_TOL["y"])
        else:
            errs[variant] = require_equal("o", got, ref)

    # the entry point, as `python -m kidney_diffusion_tpu_torch.tools.probe_int8` runs it
    for name in probe_int8.LAUNCHES:
        probe_int8.LAUNCHES[name] = 0
    results = {r["variant"]: r for r in probe_int8.run("cuda")}
    launches = dict(probe_int8.LAUNCHES)
    log(f"[probe] entry point launches: {launches}")
    require(all(launches[v] == probe_int8.REPS + 1 for v in probe_int8.VARIANTS), str(launches))

    # one-call yardsticks of the same function: x repeated along K against
    # the taps stacked along K is the tap sum as one product (prepared once)
    # (timed eagerly, as the entry point times the kernels: the plain
    # versions copy scalars from the host and cannot be captured in a graph)
    x_rep = {v: inputs[v][0].repeat(1, taps) for v in ("bf16_dot", "int8_dot")}
    w_cat = {v: inputs[v][1].reshape(taps * k, n) for v in ("bf16_dot", "int8_dot")}
    lib_ms = {"bf16_dot": eager_ms(lambda: torch.matmul(x_rep["bf16_dot"], w_cat["bf16_dot"]), 50),
              "int8_dot": eager_ms(lambda: torch._int_mm(x_rep["int8_dot"], w_cat["int8_dot"]), 50)}
    lib_name = {"bf16_dot": "torch.matmul bf16 (M x 9K) . (9K x N)",
                "int8_dot": "torch._int_mm (M x 9K) . (9K x N)"}
    rows = {}
    for variant in probe_int8.VARIANTS:
        xb = 2 if variant != "int8_dot" else 1
        wb = 2 if variant == "bf16_dot" else 1
        n_bytes = m * k * xb + taps * k * n * wb + 2.0 * m * n + 4.0
        bms, by = bound_ms(n_bytes, n_ops,
                           PEAK_BF16_FLOPS if variant == "bf16_dot" else PEAK_INT8_OPS)
        r = results[variant]
        lm = lib_ms.get(variant)
        log(f"[probe] {variant}: {r['us_per_call']:.2f} us/call, "
            f"{r['effective_tops']:.1f} TOP/s effective, bound {bms * 1e3:.2f} us ({by}); "
            f"library {lib_name.get(variant, 'none')}: "
            f"{'%.2f us' % (lm * 1e3) if lm is not None else 'none'}")
        plain_ms = eager_ms(lambda: probe_int8.probe_plain(variant, *inputs[variant]), 5)
        rows[variant] = dict(name=f"probe_int8 {variant}", launches=launches[variant],
                             max_abs_err=errs[variant], ms=r["us_per_call"] / 1e3,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lm,
                             effective_tops=r["effective_tops"])
    log(f"[probe] {time.perf_counter() - t0:.1f} s")
    return rows


def phase_forward(cascade: Cascade, params, gen):
    """Full-width stage-1 forward: kernels on the card vs plain on the CPU."""
    t0 = time.perf_counter()
    st = cascade.config.stage(1)
    bf16 = {k: v.bfloat16() for k, v in params.items()}
    x = torch.randn((1, 64, 64, 3), generator=gen, device="cuda")
    t = torch.full((1,), 0.37, device="cuda")
    with torch.no_grad():
        got = build_model(st.unet, bf16)(x, t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = build_model(st.unet, {k: v.cpu() for k, v in bf16.items()})
        ref = cpu(x.cpu(), t.cpu())
    log(f"[forward] stage 1 full width, 64² batch 1, card {t1 - t0:.1f} s, "
        f"cpu plain {time.perf_counter() - t1:.1f} s")
    check("stage-1 output", got.float().cpu(), ref.float(), FORWARD_TOL)
    log(f"[forward] {time.perf_counter() - t0:.1f} s")


def conv_shapes(unet_cfg, size: int):
    """(name, module, input shape (batch, rows, width, Cin) of one image,
    chunks) of every 3x3 conv a forward at size x size runs, derived from
    the layer names and the level structure (not from a run): a level-i
    layer sees size / 2^(i+1) pixels a side with `memory_efficient`
    downsampling at each level's entry, size / 2^i without; an upsample's
    conv sees twice its level's side; init, final block and final conv see
    the full side."""
    L, sc = unet_cfg.num_levels, unet_cfg.spatial_chunks
    ch = sc if sc and size % (sc * 2**L) == 0 and size // sc >= 2 else 0
    me = unet_cfg.memory_efficient

    def side(level):
        return size // 2 ** (level + 1) if me else size // 2**level

    for name, mod in build_model(unet_cfg).named_modules():
        if not isinstance(mod, Conv3x3):
            continue
        top = name.split(".")[0]
        m = re.fullmatch(r"(down|up)(\d+)_(\w+)", top)
        if top.startswith("mid"):
            r = side(L - 1)
        elif m is None:  # init_conv, final_block, final_conv
            r = size
        elif m.group(3) == "upsample":
            r = 2 * side(int(m.group(2)))
        else:
            r = side(int(m.group(2)))
        yield name, mod, (max(ch, 1), r // max(ch, 1), r, mod.kernel.shape[2]), ch


def conv_sites(unet_cfg, size: int):
    """(name, kernel) of every 3x3 conv a forward at size x size runs (see
    `conv_shapes`). Where `quant_conv` is on, a conv is int8 if
    `_quant_site` admits that shape; the final conv never is, nor the
    unchunked init conv (`nn.Conv` in the JAX forward). kernel is the one
    `conv3x3.route` picks: "wgmma", "narrow" or "wmma" in bf16 (the
    unchunked init conv rounds its bias in bf16), "wgmma_int8" or
    "wmma_int8" in int8."""
    sites = []
    for name, mod, shape, ch in conv_shapes(unet_cfg, size):
        top = name.split(".")[0]
        cin, cout = mod.kernel.shape[2], mod.kernel.shape[3]
        bias_in_dtype = top == "init_conv" and not ch
        int8 = (unet_cfg.quant_conv == "int8" and top != "final_conv"
                and not bias_in_dtype and _quant_site(shape, cout, ch))
        kernel = conv_mod.route(cin, cout, int8, bias_in_dtype)
        sites.append((name, "wmma_int8" if kernel == "wmma" and int8 else kernel))
    return sites


# launch counters: (name, module attribute), one per count the wrappers keep
LAUNCH_COUNTERS = (("conv3x3", "LAUNCHES"), ("conv3x3_wide", "LAUNCHES_WIDE"),
                   ("conv3x3_narrow", "LAUNCHES_NARROW"), ("conv3x3_int8", "LAUNCHES_INT8"),
                   ("conv3x3_int8_wide", "LAUNCHES_INT8_WIDE"))


def expected_launches(cfg, forwards) -> dict:
    """Kernel launches that `forwards` U-Net calls per stage must make, in
    the wrappers' counts: one per Conv3x3 module (every 3x3 conv;
    "conv3x3" the bf16 ones on any kernel, "conv3x3_wide" and
    "conv3x3_narrow" those on the wgmma and narrow kernels, "conv3x3_int8"
    the int8 ones, "conv3x3_int8_wide" those on the wgmma int8 kernel) and
    one per attention module."""
    counts = {name: 0 for name, _ in LAUNCH_COUNTERS}
    counts["attention"] = 0
    for n, fwd in forwards:
        st = cfg.stage(n)
        kinds = [k for _, k in conv_sites(st.unet, st.image_size)]
        n_int8 = kinds.count("wgmma_int8") + kinds.count("wmma_int8")
        counts["conv3x3"] += fwd * (len(kinds) - n_int8)
        counts["conv3x3_wide"] += fwd * kinds.count("wgmma")
        counts["conv3x3_narrow"] += fwd * kinds.count("narrow")
        counts["conv3x3_int8"] += fwd * n_int8
        counts["conv3x3_int8_wide"] += fwd * kinds.count("wgmma_int8")
        counts["attention"] += fwd * sum(isinstance(m, (SelfAttention, CrossAttention))
                                         for m in build_model(st.unet).modules())
    return counts


def zero_launches() -> None:
    for _, attr in LAUNCH_COUNTERS:
        setattr(conv_mod, attr, 0)
    attn_mod.LAUNCHES = 0


def read_launches() -> dict:
    counts = {name: getattr(conv_mod, attr) for name, attr in LAUNCH_COUNTERS}
    counts["attention"] = attn_mod.LAUNCHES
    return counts


def per_kernel(launches: dict) -> dict:
    """A request's launches by kernel: the WMMA kernel's bf16 and int8
    launches are what the other kernels leave of the counts."""
    return dict(launches, conv3x3=launches["conv3x3"] - launches["conv3x3_wide"]
                - launches["conv3x3_narrow"],
                conv3x3_int8=launches["conv3x3_int8"] - launches["conv3x3_int8_wide"])


def kernel_times(prof):
    """Device kernels of a torch.profiler run and each one's device time (us)."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0)
    return kernels, dev_us


def device_busy_s(fn) -> float:
    """Device busy seconds (sum of kernel times) of `fn` under torch.profiler,
    tracing the device only (a host trace of a whole request takes minutes
    to summarise)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, dev_us = kernel_times(prof)
    return sum(dev_us(e) for e in kernels) / 1e6


def phase_quant_forward(cascade: Cascade, params, gen):
    """Full-width stage 3 with the int8 + fp8 serving overrides, at the 256²
    training crop with spatial_chunks=16 (its three finest levels are int8
    sites): kernels on the card vs plain on the CPU. The same forward without
    fp8 storage, and exact (also with every bf16 conv on the WMMA kernel),
    show where the card and the CPU part: rounding flips, amplified by
    int8, then by fp8."""
    t0 = time.perf_counter()
    unet = cascade.config.stage(3).unet
    bf16 = {k: v.bfloat16() for k, v in params.items()}
    cpu_bf16 = {k: v.cpu() for k, v in bf16.items()}
    x = torch.randn((1, 256, 256, 3), generator=gen, device="cuda")
    lr = torch.rand((1, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    t = torch.full((1,), 0.37, device="cuda")
    kw = dict(lowres_cond_img=lr, lowres_noise_times=torch.full((1,), 0.2, device="cuda"))
    cpu_kw = {k: v.cpu() for k, v in kw.items()}
    with torch.no_grad():
        zero_launches()
        got = build_model(unet, bf16)(x, t, **kw).float().cpu()
        launches = read_launches()
        with wmma_only():  # the WMMA kernel's int8 mode, for the spread below
            got_wmma = build_model(unet, bf16)(x, t, **kw).float().cpu()
        t1 = time.perf_counter()
        ref = build_model(unet, cpu_bf16)(x.cpu(), t.cpu(), **cpu_kw).float()
        t_cpu = time.perf_counter() - t1
        spread = {}
        for label, variant in (("exact bf16", dict(quant_conv=None, storage_dtype=None)),
                               ("int8, bf16 storage", dict(storage_dtype=None))):
            u = dataclasses.replace(unet, **variant)
            g = build_model(u, bf16)(x, t, **kw).float().cpu()
            r = build_model(u, cpu_bf16)(x.cpu(), t.cpu(), **cpu_kw).float()
            spread[label] = ((g - r).norm() / r.norm()).item()
            if label == "exact bf16":
                exact, exact_ref = g, r
                # the same forward on the WMMA kernel alone: the spread the
                # wgmma kernel's own summation order is measured against
                with wmma_only():
                    g = build_model(u, bf16)(x, t, **kw).float().cpu()
                spread["exact bf16 on the WMMA kernel alone"] = (
                    (g - exact_ref).norm() / exact_ref.norm()).item()
    want = expected_launches(dataclasses.replace(
        cascade.config, stages=cascade.config.stages[:2] + (dataclasses.replace(
            cascade.config.stage(3), image_size=256),)), ((3, 1),))
    log(f"[forward] stage 3 int8 + fp8 storage, full width, 256² batch 1, spatial_chunks="
        f"{unet.spatial_chunks}: launches {launches} (expected {want}), "
        f"cpu plain {t_cpu:.1f} s")
    require(launches == want and launches["conv3x3_int8_wide"] > 0, str((launches, want)))
    spread["int8 + fp8 on the WMMA kernel alone"] = ((got_wmma - ref).norm() / ref.norm()).item()
    spread["int8 + fp8"] = ((got - ref).norm() / ref.norm()).item()
    log(f"[forward] int8 + fp8 vs the exact bf16 path on the card: normwise "
        f"{((got - exact).norm() / exact.norm()).item():.3e}; card vs CPU normwise: "
        + ", ".join(f"{k} {v:.3e}" for k, v in spread.items()))
    check("stage-3 int8 + fp8 output", got, ref, QUANT_FORWARD_TOL)
    # the storage cast and the re-anchor amax in e5m2 on the card equal the
    # CPU's (torch's cast is JAX's rule, held on the CPU by the tests), on a
    # spread of magnitudes with its edges (57344, 61440, inf, NaN); drawn
    # from a generator of its own, so the run's later draws stay as they were
    g8 = torch.Generator(device="cuda").manual_seed(8)
    v = torch.randn((1 << 20,), generator=g8, device="cuda") * torch.exp2(
        torch.randint(-20, 12, (1 << 20,), generator=g8, device="cuda").float())
    v[:6] = torch.tensor([57344.0, 61440.0, -61440.0, 2.0**-17, float("inf"), float("nan")])
    v = v.bfloat16()
    card, host = cast_storage(v, torch.float8_e5m2), cast_storage(v.cpu(), torch.float8_e5m2)
    same = torch.equal(card.view(torch.uint8).cpu(), host.view(torch.uint8))
    amaxes = [(dynamic_amax(a).cpu(), dynamic_amax(a.cpu())) for a in (card[6:], card[:5], card)]
    amax_same = all(bool((a == b) | (a.isnan() & b.isnan())) for a, b in amaxes)
    log(f"[forward] e5m2 storage cast of {v.numel()} bf16 values on the card bit-equal to the "
        f"CPU's: {same}; dynamic_amax equal: {amax_same} {[a.item() for a, _ in amaxes]}")
    require(same and amax_same, "e5m2 cast or amax differs between the card and the CPU")
    # the same forward with float8_e5m2 storage (the CLIs' other storage
    # choice), and with e5m2 storage alone (bf16 convs): where the spread
    # comes from
    e5m2 = dataclasses.replace(unet, storage_dtype="float8_e5m2")
    with torch.no_grad():
        zero_launches()
        got5 = build_model(e5m2, bf16)(x, t, **kw).float().cpu()
        launches5 = read_launches()
        t1 = time.perf_counter()
        ref5 = build_model(e5m2, cpu_bf16)(x.cpu(), t.cpu(), **cpu_kw).float()
        t_cpu5 = time.perf_counter() - t1
        bf16_e5m2 = dataclasses.replace(e5m2, quant_conv=None)
        g = build_model(bf16_e5m2, bf16)(x, t, **kw).float().cpu()
        r = build_model(bf16_e5m2, cpu_bf16)(x.cpu(), t.cpu(), **cpu_kw).float()
    spread5 = {"e5m2 storage alone": ((g - r).norm() / r.norm()).item(),
               "int8 + e5m2": ((got5 - ref5).norm() / ref5.norm()).item()}
    log(f"[forward] stage 3 int8 + fp8 e5m2 storage: launches {launches5}, cpu plain "
        f"{t_cpu5:.1f} s; card vs CPU normwise: "
        + ", ".join(f"{k} {v:.3e}" for k, v in spread5.items())
        + f" (int8 + e4m3fn {spread['int8 + fp8']:.3e})")
    require(launches5 == want, str((launches5, want)))
    check("stage-3 int8 + fp8 e5m2 output", got5, ref5, QUANT_FORWARD_TOL_E5M2)
    log(f"[forward] {time.perf_counter() - t0:.1f} s")


class StageClock:
    """CUDA events at every U-Net forward's entry and exit, by stage, and a
    count of non-finite outputs (every U-Net output must be finite)."""

    def __init__(self, cfg):
        self.unets = [st.unet for st in cfg.stages]
        self.events = {}
        self.bad = torch.zeros((), dtype=torch.int64, device="cuda")
        self.n_fwd = 0
        self._open = None

    def pre(self, module, args):
        if isinstance(module, EfficientUNet):
            self._open = torch.cuda.Event(enable_timing=True)
            self._open.record()

    def post(self, module, args, output):
        if isinstance(module, EfficientUNet):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            stage = self.unets.index(module.config) + 1
            self.events.setdefault(stage, []).append((self._open, end))
            self.bad.add_((~torch.isfinite(output)).sum())
            self.n_fwd += 1

    def per_stage(self) -> dict:
        """stage -> (forwards, mean forward ms, stage span ms per step)."""
        out = {}
        for stage, ev in sorted(self.events.items()):
            fwd_ms = sum(s.elapsed_time(e) for s, e in ev) / len(ev)
            out[stage] = (len(ev), fwd_ms, ev[0][0].elapsed_time(ev[-1][1]) / len(ev))
        return out


def phase_profile(cascades, params, gen):
    """Requests A and C stage by stage: wall seconds (unprofiled), device busy
    time from a second, profiled run, the idle share 1 - busy / wall, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    for label, cascade in cascades.items():
        img = None
        for n, steps in FORWARDS_A:
            kw = dict(dpmpp_steps=steps) if n < 3 else dict(use_ddim=True, ddim_steps=steps)

            def run():
                out = cascade.sample_stage(params[n - 1], n, gen, batch_size=1,
                                           lowres_image=img, **kw)
                torch.cuda.synchronize()
                return out

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()  # unprofiled: the wall time the idle share is taken against
            wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                img = run()
            kernels, dev_us = kernel_times(prof)
            busy = sum(dev_us(e) for e in kernels) / 1e6
            log(f"[profile] {label} stage {n}: {steps} steps, wall {wall:.3f} s "
                f"({wall / steps * 1e3:.1f} ms/step), device busy {busy:.3f} s, "
                f"idle share {max(0.0, 1 - busy / wall):.3f}")
            for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
                log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms {e.count:6d} calls  {e.key[:90]}")


def serve_request(label, cascade, params, gen, forwards, **kw):
    """One request through `Cascade.sample` with the launch counts zeroed just
    before and read just after; checks every forward ran and was finite and
    the counts equal the model's layers. Returns the output, wall seconds,
    launches, peak GiB and the per-stage CUDA-event times."""
    clock = StageClock(cascade.config)
    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(clock.pre),
             torch.nn.modules.module.register_module_forward_hook(clock.post)]
    try:
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = cascade.sample(params, gen, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        launches = read_launches()
    finally:
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] {label}: {sec:.2f} s, out {tuple(out.shape)} {out.dtype} "
        f"range [{out.min().item():.4g}, {out.max().item():.4g}] "
        f"mean {out.float().mean().item():.4g}, unet forwards {clock.n_fwd}, "
        f"non-finite unet outputs {clock.bad.item()}, launches {launches}, "
        f"max_memory_allocated {peak:.2f} GiB")
    require(clock.bad.item() == 0 and clock.n_fwd == sum(f for _, f in forwards),
            f"{label}: non-finite outputs {clock.bad.item()}, forwards {clock.n_fwd}")
    # every conv3x3 and attention site of every forward went through its kernel
    want = expected_launches(cascade.config, forwards)
    log(f"[serve] {label}: launches expected from the model's layers: {want}")
    require(launches == want, f"{label}: {launches} != {want}")
    return out, sec, launches, peak, clock.per_stage()


def phase_serve(cascades, params, gen):
    t0 = time.perf_counter()
    cfg = cascades["A"].config
    launches, walls, peaks, stages, outs = {}, {}, {}, {}, {}
    for label in ("A", "C"):
        # (A) one 1024² patch at the shipped serving mix; (C) the same on the
        # shipped serving overrides: stage 3 on int8 convs with fp8 storage
        out, walls[label], launches[label], peaks[label], stages[label] = serve_request(
            label, cascades[label], params, gen, FORWARDS_A, batch_size=1,
            output_dtype="uint8", **SERVE_A)
        require(tuple(out.shape) == (1, 1024, 1024, 3) and out.dtype == torch.uint8,
                f"request {label} output {tuple(out.shape)} {out.dtype}")
        outs[label] = out[0].cpu().numpy()
        require(min(launches[label][k] for k in ("conv3x3", "attention")) > 0, str(launches))
        if label == "A":
            # (B) stage 1 alone, ancestral loop cut to 8 steps, batch 2
            cfg_b = dataclasses.replace(
                cfg, stages=(dataclasses.replace(cfg.stage(1), timesteps=8),) + cfg.stages[1:])
            out_b, _, launches["B"], _, _ = serve_request(
                "B", Cascade(cfg_b, device="cuda"), params, gen, ((1, 8),), batch_size=2,
                stop_at_unet_number=1)
            require(tuple(out_b.shape) == (2, 64, 64, 3) and torch.isfinite(out_b).all().item(),
                    f"request B output {tuple(out_b.shape)}")
            require(0.0 <= out_b.min().item() and out_b.max().item() <= 1.0, "request B range")
    require(launches["C"]["conv3x3_int8"] > 0, str(launches["C"]))
    for name, want in (("conv3x3_wide", WIDE_LAUNCHES), ("conv3x3_narrow", NARROW_LAUNCHES),
                       ("conv3x3_int8_wide", INT8_WIDE_LAUNCHES)):
        got = {k: launches[k][name] for k in want}
        log(f"[serve] {name} launches {got} (the sites: {want})")
        require(got == want, f"{name} launches {got} != {want}")
    wmma = {k: (per_kernel(launches[k])["conv3x3"], per_kernel(launches[k])["conv3x3_int8"])
            for k in ("A", "C")}
    log(f"[serve] WMMA kernel launches (bf16, int8): {wmma}")
    require(all(v == (0, 0) for v in wmma.values()), f"flagship calls on the WMMA kernel: {wmma}")
    for n, steps in FORWARDS_A:
        fa, fc = stages["A"][n], stages["C"][n]
        log(f"[serve] stage {n} ({steps} steps): A {fa[2]:.2f} ms/step (forward {fa[1]:.2f} ms), "
            f"C {fc[2]:.2f} ms/step (forward {fc[1]:.2f} ms) [CUDA events]")
    # device busy time of each request, from a second, profiled run
    for label in ("A", "C"):
        c = cascades[label]
        busy = device_busy_s(lambda: c.sample(params, gen, batch_size=1, output_dtype="uint8",
                                              **SERVE_A))
        log(f"[serve] {label}: wall {walls[label]:.3f} s, device busy {busy:.3f} s "
            f"(profiled rerun), idle share {max(0.0, 1 - busy / walls[label]):.3f}, "
            f"peak {peaks[label]:.2f} GiB")
    log(f"[serve] {time.perf_counter() - t0:.1f} s")
    return launches, outs["C"]


def random_params(config, n: int, gen) -> dict:
    """Stage `n`'s fp32 parameters drawn from `gen` on the card with no
    zero-initialised layer (as `random_flax_params` in the tests): kernels
    N(0, 1 / fan_in), norm scales 1 + 0.1 N(0, 1), other vectors 0.1 N(0, 1).
    Flax's zero final conv would zero every gradient upstream of it."""
    out = {}
    for name, meta in init_stage_params(config, n, device="meta").items():
        z = torch.randn(meta.shape, generator=gen, device="cuda")
        if meta.dim() >= 2:
            z /= math.sqrt(math.prod(meta.shape[:-1]))
        elif name.endswith("scale"):
            z = 1.0 + 0.1 * z
        else:
            z *= 0.1
        out[name] = z
    return out


# ---------------------------------------------------------------------------
# gigapixel: one mag-1 level (G), its transports (G'), the mag-2 filter (M2)
# ---------------------------------------------------------------------------


def level_forwards(cfg, patch_pos):
    """((stage, U-Net forwards), ...) of one gigapixel level at the GIGA
    settings: each stage's chunks of the wave plan (`gigapixel._stage_batch`
    caps) times its sampler steps (one forward a step on DPM++ and DDIM)."""
    waves = plan_waves(patch_pos, choose_orientation(patch_pos))
    out = []
    for n in range(1, cfg.num_stages + 1):
        cap = gp._stage_batch(cfg.stage(n).image_size, GIGA["max_wave_batch"], None, 1,
                              n == cfg.num_stages)
        steps = (stage_sampler_steps(GIGA["dpmpp_steps"], n, cfg.num_stages)
                 or stage_sampler_steps(GIGA["ddim_steps"], n, cfg.num_stages))
        out.append((n, steps * sum(-(-len(w) // cap) for w in waves)))
    return tuple(out)


def wmma_sites(cfg, forwards) -> int:
    """WMMA launches of `forwards`: the bf16 convs `conv3x3.route` leaves to
    the WMMA kernel (none at the served configs' widths)."""
    return sum(fwd * [k for _, k in conv_sites(cfg.stage(n).unet, cfg.stage(n).image_size)]
               .count("wmma") for n, fwd in forwards)


def check_overlap_bands(label, patches, ori, ov) -> int:
    """Every patch's band shared with a generated neighbour above it and
    next to it (in the sweep direction) equals that neighbour's pixels: the
    masked loop pastes the known pixels. Returns the bands checked."""
    n = 0
    for (i, j), p in patches.items():
        up, side = patches.get((i - 1, j)), patches.get((i, j + ori))
        if up is not None:
            require(np.array_equal(p[:ov], up[-ov:]), f"{label}: {(i, j)} top band")
            n += 1
        if side is not None:
            same = (np.array_equal(p[:, -ov:], side[:, :ov]) if ori == 1
                    else np.array_equal(p[:, :ov], side[:, -ov:]))
            require(same, f"{label}: {(i, j)} side band")
            n += 1
    return n


def check_patches(label, patches, pos, ps):
    require(sorted(patches) == sorted(pos), f"{label}: patches {sorted(patches)[:4]}")
    require(all(p.shape == (ps, ps, 3) and p.dtype == np.uint8 for p in patches.values()),
            f"{label}: patch shapes {set((p.shape, p.dtype) for p in patches.values())}")


@contextlib.contextmanager
def instrument_level(cascade, capture=False):
    """Records of one level on `cascade`: each `sample_stage` call (stage,
    batch, CUDA events around it; with `capture`, its image inputs on the
    host), host seconds in `stage_model` and `ResidentEngine.prep_chunk`,
    non-finite and counted U-Net outputs (a forward hook on each stage
    model), the engine's copies of final patches to the host (synchronised
    first, so only the copy is timed), and a metrics hook that synchronises
    at each stage's last wave for the stage's wall."""
    rec = dict(calls=[], build_s=0.0, prep_s=0.0, stage_end={}, rerun={}, copies=0, copy_s=0.0,
               inputs=[], forwards={}, bad=torch.zeros((), dtype=torch.int64, device="cuda"))
    orig_sample, orig_model = cascade.sample_stage, cascade.stage_model
    orig_prep, orig_copy = ResidentEngine.prep_chunk, ResidentEngine._copy_finals
    hooked, handles = set(), []

    def stage_model(params, n):
        t = time.perf_counter()
        model = orig_model(params, n)
        rec["build_s"] += time.perf_counter() - t
        if id(model) not in hooked:
            hooked.add(id(model))

            def post(module, args, out, n=n):
                rec["bad"].add_((~torch.isfinite(out)).sum())
                rec["forwards"][n] = rec["forwards"].get(n, 0) + 1

            handles.append(model.register_forward_hook(post))
        return model

    def sample_stage(params, n, noise, **kw):
        if capture:
            rec["inputs"].append((n, kw["batch_size"], {
                k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in kw.items() if k in ("cond_images", "lowres_image", "inpaint_images",
                                                "inpaint_masks")}))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_sample(params, n, noise, **kw)
        end.record()
        rec["calls"].append((n, kw["batch_size"], start, end))
        if kw["batch_size"] >= rec["rerun"].get(n, (0,))[0]:  # the largest chunk, for reruns
            rec["rerun"][n] = (kw["batch_size"], kw)
        return out

    def prep_chunk(self, *args, **kwargs):
        t = time.perf_counter()
        out = orig_prep(self, *args, **kwargs)
        rec["prep_s"] += time.perf_counter() - t
        return out

    def copy_finals(self):
        if self._final_pending:
            torch.cuda.synchronize()
            t = time.perf_counter()
            orig_copy(self)
            rec["copy_s"] += time.perf_counter() - t
            rec["copies"] += 1

    def hook(stage, wave, patches, device_store_entries):
        if wave == rec["n_waves"] - 1:
            torch.cuda.synchronize()
            rec["stage_end"][stage] = time.perf_counter()

    cascade.sample_stage, cascade.stage_model = sample_stage, stage_model
    ResidentEngine.prep_chunk, ResidentEngine._copy_finals = prep_chunk, copy_finals
    try:
        yield rec, hook
    finally:
        del cascade.sample_stage, cascade.stage_model
        ResidentEngine.prep_chunk, ResidentEngine._copy_finals = orig_prep, orig_copy
        for h in handles:
            h.remove()


def rerun_chunk(cascade, params, n, rec, gen):
    """The level's largest chunk of stage n again: wall on the level's stage
    model (as the level ran it; the faster of two runs) and device busy
    time under torch.profiler; then what building the model on every call
    would add: `Cascade.stage_model` anew and the quantization of its int8
    weights (done at their first forward), each synchronised."""
    bsz, kw = rec["rerun"][n]

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cascade.sample_stage(params[n - 1], n, gen, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    warm = min(run(), run())
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    kernels, dev_us = kernel_times(prof)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    for e in sorted(kernels, key=dev_us, reverse=True)[:4]:
        log(f"[gigapixel]   stage {n} chunk: {dev_us(e) / 1e3:9.2f} ms {e.count:6d} calls  "
            f"{e.key[:80]}")
    t = time.perf_counter()
    model = cascade.stage_model(params[n - 1], n)
    torch.cuda.synchronize()
    build = time.perf_counter() - t
    st = cascade.config.stage(n)
    int8 = [model.get_submodule(name) for name, kernel in conv_sites(st.unet, st.image_size)
            if kernel in ("wgmma_int8", "wmma_int8")]
    t = time.perf_counter()
    for mod in int8:
        mod.quantized_weights(mod.kernel.to(mod.dtype))
    torch.cuda.synchronize()
    quant = time.perf_counter() - t
    return dict(batch=bsz, wall_s=warm, busy_s=busy, idle_share=max(0.0, 1 - busy / warm),
                build_s=build, quantize_s=quant, build_share=(build + quant) / warm)


def phase_gigapixel_level(cascade, params, zoomed, gen, smi):
    """Request G: `generate_high_res_image`'s three calls (get_cond_images,
    generate_patch_set, stitch_patches) on one mag-1 level, so the patches
    are kept for the checks."""
    t0 = time.perf_counter()
    cfg = cascade.config
    ps = cfg.stages[-1].image_size
    _, pos, grid = gp.get_cond_images(zoomed, 1, overlap=GIGA["overlap"], patch_size=ps,
                                      materialize=False, device="cuda")
    pos = pos[:GIGA_PATCHES]
    ori = choose_orientation(pos)
    waves = plan_waves(pos, ori)
    forwards = level_forwards(cfg, pos)
    want = expected_launches(cfg, forwards)
    log(f"[gigapixel] G: mag 1, {len(pos)} patches of a {grid.num_patches_width}² grid "
        f"(patch width {grid.patch_width}, stride {grid.patch_dist}), {len(waves)} waves of "
        f"{[len(w) for w in waves]}, orientation {ori}, forwards {forwards}")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    with instrument_level(cascade) as (rec, hook):
        rec["n_waves"] = len(waves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        patches = gp.generate_patch_set(
            cascade, params, gen, patch_pos=pos, grid=grid, cond_images=None,
            inpaint_resample_times=GIGA["inpaint_resample_times"],
            max_wave_batch=GIGA["max_wave_batch"], store_dtype=np.uint8, progress=False,
            dpmpp_steps=GIGA["dpmpp_steps"], ddim_steps=GIGA["ddim_steps"], wire="resident",
            zoomed_image=zoomed, metrics_hook=hook)
        t2 = time.perf_counter()
        launches = read_launches()
        canvas = gp.stitch_patches(zoomed, patches, overlap=GIGA["overlap"],
                                   num_patches_width=grid.num_patches_width, patch_size=ps)
        t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = t2 - t1
    log(f"[gigapixel] G: level {wall:.3f} s ({len(pos) / wall:.4f} patches/s), stitch "
        f"{t3 - t2:.3f} s, canvas {canvas.shape} {canvas.dtype}, peak {peak:.2f} GiB [{smi}]")
    full = ps + (grid.num_patches_width - 1) * int(ps * (1 - GIGA["overlap"]))
    require(canvas.shape == (full, full, 3) and canvas.dtype == np.uint8, f"G canvas {canvas.shape}")
    check_patches("G", patches, pos, ps)
    n_fwd = tuple((n, rec["forwards"].get(n, 0)) for n in (1, 2, 3))
    log(f"[gigapixel] G: unet forwards {n_fwd}, non-finite outputs {rec['bad'].item()}")
    require(rec["bad"].item() == 0 and n_fwd == forwards, f"G: {rec['bad'].item()}, {n_fwd}")
    ov = int(GIGA["overlap"] * ps)
    bands = check_overlap_bands("G", patches, ori, ov)
    log(f"[gigapixel] G: {bands} overlap bands of {ov} px equal their generated neighbour's pixels")
    # the canvas: each patch pasted (the bands agree, so the order does not
    # matter), the upscaled coarse image elsewhere
    covered = np.zeros(canvas.shape[:2], bool)
    pd = int(ps * (1 - GIGA["overlap"]))
    for (i, j), p in patches.items():
        require(np.array_equal(canvas[i * pd:i * pd + ps, j * pd:j * pd + ps], p),
                f"G: canvas at {(i, j)} is not the patch")
        covered[i * pd:i * pd + ps, j * pd:j * pd + ps] = True
    if not covered.all():
        up = gp.stitch_patches(zoomed, {}, overlap=GIGA["overlap"],
                               num_patches_width=grid.num_patches_width, patch_size=ps)
        require(np.array_equal(canvas[~covered], up[~covered]), "G: canvas background")
    log(f"[gigapixel] G: canvas == the patches pasted onto the upscaled coarse image "
        f"({covered.mean():.4f} of it covered by patches)")
    # launches: one per 3x3 conv and attention layer of every forward; none
    # on the WMMA kernel, every init conv (Cin 6 and 9) on the narrow one
    wmma = per_kernel(launches)["conv3x3"]
    log(f"[gigapixel] G: launches {launches} (expected {want}); narrow "
        f"{launches['conv3x3_narrow']} (required {GIGA_NARROW_LAUNCHES}), WMMA {wmma} (required "
        f"{GIGA_WMMA_LAUNCHES}), WMMA int8 {per_kernel(launches)['conv3x3_int8']}")
    require(launches == want, f"G launches {launches} != {want}")
    require(wmma == wmma_sites(cfg, forwards) == GIGA_WMMA_LAUNCHES
            and per_kernel(launches)["conv3x3_int8"] == 0, f"G: WMMA launches {wmma}")
    require(launches["conv3x3_narrow"] == GIGA_NARROW_LAUNCHES,
            f"G: narrow launches {launches['conv3x3_narrow']}")
    # where the time went, per stage
    starts = {1: t1, 2: rec["stage_end"][1], 3: rec["stage_end"][2]}
    stages = {}
    for n in (1, 2, 3):
        calls = [c for c in rec["calls"] if c[0] == n]
        span = sum(s.elapsed_time(e) for _, _, s, e in calls) / 1e3
        st_wall = rec["stage_end"][n] - starts[n]
        stages[n] = dict(wall_s=st_wall, device_span_s=span, span_share=span / st_wall,
                         calls=len(calls), mean_batch=sum(b for _, b, _, _ in calls) / len(calls),
                         patches_per_call=len(pos) / len(calls), forwards=dict(forwards)[n],
                         **{f"chunk_{k}": v for k, v in rerun_chunk(cascade, params, n, rec,
                                                                    gen).items()})
        st = stages[n]
        log(f"[gigapixel] G stage {n}: wall {st_wall:.3f} s, device span {span:.3f} s (CUDA "
            f"events around its {len(calls)} sample_stage calls; {st['span_share']:.3f} of the "
            f"wall), mean batch {st['mean_batch']:.3f} ({st['patches_per_call']:.3f} patches a "
            f"call), {st['forwards']} forwards; its largest chunk (batch {st['chunk_batch']}) "
            f"again: wall {st['chunk_wall_s']:.3f} s, device busy {st['chunk_busy_s']:.3f} s, "
            f"idle share {st['chunk_idle_share']:.3f}; building its model anew: "
            f"{st['chunk_build_s']:.4f} s + int8 weights {st['chunk_quantize_s']:.4f} s "
            f"({st['chunk_build_share']:.3f} of the chunk's wall, what each call would add "
            f"if the model were built per call)")
    log(f"[gigapixel] G: host seconds in prep {rec['prep_s']:.3f}, in stage_model (one build "
        f"a stage) {rec['build_s']:.3f}; final patches to the host in {rec['copies']} "
        f"synchronous copies, {rec['copy_s']:.4f} s (none of it overlaps compute)")
    log(f"[gigapixel] G {time.perf_counter() - t0:.1f} s")
    return canvas, launches, dict(
        patches=len(pos), wall_s=wall, patches_per_s=len(pos) / wall, stitch_s=t3 - t2,
        peak_gib=peak, prep_s=rec["prep_s"], build_s=rec["build_s"], copies=rec["copies"],
        copy_s=rec["copy_s"],
        stages=stages, bands=bands)


def phase_gigapixel_wires(cascade, params, zoomed, seed):
    """Request G': the first patches of the level on the uint8 wire and on
    the resident transport from one generator seed. Every chunk's
    conditioning inputs must agree: cond crops, low-res and masks exactly,
    strips exactly where a generated neighbour gives them and within one
    count at coarse-fallback pixels."""
    t0 = time.perf_counter()
    ps = cascade.config.stages[-1].image_size
    conds, pos, grid = gp.get_cond_images(zoomed, 1, overlap=GIGA["overlap"], patch_size=ps)
    conds, pos = conds[:GIGA_WIRE_PATCHES], pos[:GIGA_WIRE_PATCHES]
    ori = choose_orientation(pos)
    runs = {}
    for wire in ("uint8", "resident"):
        with instrument_level(cascade, capture=True) as (rec, hook):
            rec["n_waves"] = len(plan_waves(pos, ori))
            t = time.perf_counter()
            out = gp.generate_patch_set(
                cascade, params, torch.Generator(device="cuda").manual_seed(seed), patch_pos=pos,
                grid=grid, cond_images=conds if wire == "uint8" else None,
                inpaint_resample_times=GIGA["inpaint_resample_times"],
                max_wave_batch=GIGA["max_wave_batch"], store_dtype=np.uint8, progress=False,
                dpmpp_steps=GIGA["dpmpp_steps"], ddim_steps=GIGA["ddim_steps"], wire=wire,
                zoomed_image=zoomed if wire == "resident" else None, metrics_hook=hook)
            runs[wire] = (rec["inputs"], out, time.perf_counter() - t)
        check_patches(f"G' {wire}", out, pos, ps)
    (host_in, host_out, host_s), (res_in, res_out, res_s) = runs["uint8"], runs["resident"]
    require(len(host_in) == len(res_in), f"G': {len(host_in)} != {len(res_in)} calls")
    # the chunks in call order, for the fallback pixels of each
    chunks = []
    for n in (1, 2, 3):
        cap = gp._stage_batch(cascade.config.stage(n).image_size, GIGA["max_wave_batch"], None, 1,
                              n == 3)
        for wave in plan_waves(pos, ori):
            chunks += [(n, wave[k:k + cap]) for k in range(0, len(wave), cap)]
    n_fallback, n_strip = 0, 0
    done = {n: [] for n in (1, 2, 3)}
    for (n, chunk), (hn, hb, h), (rn, rb, r) in zip(chunks, host_in, res_in):
        require(hn == rn == n and hb == rb == bucket_size(len(chunk)), f"G' call {hn} {rn} {n}")
        require(sorted(h) == sorted(r), f"G' stage {n}: inputs {sorted(h)} != {sorted(r)}")
        for k in ("cond_images", "lowres_image", "inpaint_masks"):
            if k in h:
                require(h[k].shape == r[k].shape and np.array_equal(h[k], r[k]),
                        f"G' stage {n} {chunk}: {k} differs")
        if "inpaint_images" in h:
            hs = h["inpaint_images"].shape[1]
            marked = gp.assemble_inpaint_strips(
                chunk, {p: np.zeros((hs, hs, 3), np.uint8) for p in done[n]},
                {p: np.full((ps, ps, 3), -1.0, np.float32) for p in chunk}, grid, hs, ori)[0]
            fallback = gp._pad_to(marked < 0, hb)
            diff = np.abs(h["inpaint_images"].astype(int) - r["inpaint_images"].astype(int))
            require(diff[~fallback].max(initial=0) == 0 and diff[fallback].max(initial=0) <= 1,
                    f"G' stage {n} {chunk}: strips differ by {diff.max()}")
            n_fallback += int(fallback[:len(chunk)].sum())
            n_strip += int(h["inpaint_masks"][:len(chunk)].sum()) * 3
        done[n] += chunk
    differ = np.mean([np.mean(host_out[p] != res_out[p]) for p in pos])
    log(f"[gigapixel] G': {len(pos)} patches, {len(host_in)} calls a wire: cond crops, low-res "
        f"and masks equal; strips equal from generated neighbours ({n_strip} known values), "
        f"within one count at {n_fallback} coarse-fallback values; uint8 wire {host_s:.3f} s, "
        f"resident {res_s:.3f} s; {differ:.6f} of the output values differ")
    log(f"[gigapixel] G' {time.perf_counter() - t0:.1f} s")
    return dict(uint8_s=host_s, resident_s=res_s, differing_share=float(differ),
                fallback_values=n_fallback)


def phase_gigapixel_mag2(canvas, params, gen):
    """M2: the mag-2 tissue filter on G's canvas on the card against the
    CPU, then the first patches of `ultra_res(2, "v_param")` (int8 + fp8
    overrides) on the resident transport from G's weights (random weights
    make no tissue: `all_patches`). No stitch: the mag-2 canvas of this level
    is 40960² x 3."""
    t0 = time.perf_counter()
    zoomed = canvas.astype(np.float32) / 255.0
    t = time.perf_counter()
    mask = foreground_mask_for_patches(zoomed, device="cuda").cpu().numpy()
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    mask_cpu = foreground_mask_for_patches(zoomed, device="cpu").numpy()
    t_cpu = time.perf_counter() - t
    require(np.array_equal(mask, mask_cpu), "M2: the card's tissue mask differs from the CPU's")
    cfg = serving_overrides(ultra_res(2, "v_param"), quant="int8", storage="float8_e4m3fn")
    ps = cfg.stages[-1].image_size
    grid2 = gp.GridSpec.build(zoomed.shape[1], 2, GIGA["overlap"], patch_size=ps)
    keep = gp.tissue_patch_filter(zoomed, grid2, device="cuda")
    log(f"[gigapixel] M2: tissue mask {mask.shape} on the card ({t_card:.3f} s) == on the CPU "
        f"({t_cpu:.3f} s), {mask.mean():.6f} foreground; tissue_patch_filter keeps {len(keep)} "
        f"of {grid2.num_patches_width ** 2} patches")
    for n in (1, 2, 3):
        shapes = {k: tuple(v.shape) for k, v in init_stage_params(cfg, n, device="meta").items()}
        require(shapes == {k: tuple(v.shape) for k, v in params[n - 1].items()},
                f"M2: stage {n}'s parameters differ in shape from mag 1's")
    cascade = Cascade(cfg, device="cuda")
    _, pos, grid = gp.get_cond_images(zoomed, 2, overlap=GIGA["overlap"], patch_size=ps,
                                      all_patches=True, materialize=False)
    pos = pos[:GIGA_WIRE_PATCHES]
    with instrument_level(cascade) as (rec, hook):
        rec["n_waves"] = len(plan_waves(pos, choose_orientation(pos)))
        t = time.perf_counter()
        patches = gp.generate_patch_set(
            cascade, params, gen, patch_pos=pos, grid=grid, cond_images=None,
            inpaint_resample_times=GIGA["inpaint_resample_times"],
            max_wave_batch=GIGA["max_wave_batch"], store_dtype=np.uint8, progress=False,
            dpmpp_steps=GIGA["dpmpp_steps"], ddim_steps=GIGA["ddim_steps"], wire="resident",
            zoomed_image=zoomed, metrics_hook=hook)
        wall = time.perf_counter() - t
    check_patches("M2", patches, pos, ps)
    require(rec["bad"].item() == 0, f"M2: {rec['bad'].item()} non-finite U-Net outputs")
    bands = check_overlap_bands("M2", patches, choose_orientation(pos), int(GIGA["overlap"] * ps))
    log(f"[gigapixel] M2: {len(pos)} mag-2 patches of a {grid.num_patches_width}² grid (patch "
        f"width {grid.patch_width}) in {wall:.3f} s, {bands} overlap bands equal, forwards "
        f"{rec['forwards']}")
    log(f"[gigapixel] M2 {time.perf_counter() - t0:.1f} s")
    return dict(mask_card_s=t_card, mask_cpu_s=t_cpu, tissue_patches=len(keep),
                grid_patches=grid2.num_patches_width ** 2, patches=len(pos), wall_s=wall)


def phase_gigapixel(mag0, gen, seed, smi):
    """Gigapixel serving from the port (see the module docstring)."""
    t0 = time.perf_counter()
    cfg = serving_overrides(ultra_res(1, "v_param"), quant="int8", storage="float8_e4m3fn")
    cascade = Cascade(cfg, device="cuda")
    params = [random_params(cfg, n, gen) for n in (1, 2, 3)]
    zoomed = mag0.astype(np.float32) / 255.0
    canvas, launches, nums = phase_gigapixel_level(cascade, params, zoomed, gen, smi)
    nums["wires"] = phase_gigapixel_wires(cascade, params, zoomed, seed)
    nums["mag2"] = phase_gigapixel_mag2(canvas, params, gen)
    log(f"[gigapixel] {time.perf_counter() - t0:.1f} s")
    return launches, nums


def crop_config(cfg):
    """The cascade with stage 3 at the size its training crop gives its
    U-Net: the shapes of a train step's forward, for `expected_launches`."""
    return dataclasses.replace(cfg, stages=cfg.stages[:2] + (
        dataclasses.replace(cfg.stage(3), image_size=cfg.stage(3).random_crop_size),))


def train_sites(cfg, n: int) -> dict:
    """Launches per kernel of one train step of stage `n` (one forward at
    the training size; the backward launches none). `remat` recomputes every
    ResnetBlock's two convs in the backward: those count twice."""
    cfg = crop_config(cfg) if n == 3 else cfg
    st = cfg.stage(n)
    want = expected_launches(cfg, ((n, 1),))
    if st.unet.remat:
        for name, kernel in conv_sites(st.unet, st.image_size):
            if re.fullmatch(r"(down\d+_block\d+|mid_block\d|up\d+_block\d+|final_block)\..*",
                            name):
                want["conv3x3"] += 1
                want[{"wgmma": "conv3x3_wide", "narrow": "conv3x3_narrow"}.get(
                    kernel, "conv3x3")] += kernel != "wmma"
    return want


def train_draws(cfg, gen, batch: int) -> dict:
    """One set of stage-3 `stage_loss` draws (`Cascade.stage_loss`'s names),
    made on the card."""
    size, crop, dev = cfg.stage(3).image_size, cfg.stage(3).random_crop_size, "cuda"
    return {"times": torch.rand((batch,), generator=gen, device=dev),
            "noise": torch.randn((batch, crop, crop, 3), generator=gen, device=dev),
            "crop_ys": torch.randint(0, size - crop + 1, (batch,), generator=gen, device=dev),
            "crop_xs": torch.randint(0, size - crop + 1, (batch,), generator=gen, device=dev),
            "aug_times": torch.rand((batch,), generator=gen, device=dev)
            * cfg.lowres_max_aug_level,
            "aug_noise": torch.randn((batch, crop, crop, 3), generator=gen, device=dev)}


def phase_grad_check(cascade: Cascade, gen, smi: str) -> dict:
    """One full-width stage-3 loss and gradient (B=1, the 256² crop of a
    1024² image) through the kernels on the card against the plain path on
    the CPU, same weights and draws: the loss within LOSS_TOL relative, all
    gradients together within GRAD_TOL normwise; every parameter's gradient
    on the card finite and non-zero; the forward's launches those of its
    sites."""
    t0 = time.perf_counter()
    cfg = cascade.config
    params = random_params(cfg, 3, gen)
    size = cfg.stage(3).image_size
    images = torch.rand((1, size, size, 3), generator=gen, device="cuda")
    draws = train_draws(cfg, gen, 1)
    out = {}
    for dev in ("cuda", "cpu"):
        c = cascade if dev == "cuda" else Cascade(cfg, device="cpu")
        ps = {k: torch.nn.Parameter(v.to(dev)) for k, v in params.items()}
        t1 = time.perf_counter()
        zero_launches()
        loss = c.stage_loss(ps, 3, None, images.to(dev),
                            draws={k: v.to(dev) for k, v in draws.items()})
        launches = read_launches()
        grads = [g.cpu() for g in torch.autograd.grad(loss, list(ps.values()))]
        out[dev] = (loss.item(), grads, launches, time.perf_counter() - t1)
        del ps, loss
    names = list(params)
    (l_card, g_card, launches, s_card), (l_cpu, g_cpu, _, s_cpu) = out["cuda"], out["cpu"]
    want = train_sites(cfg, 3)
    crop = cfg.stage(3).random_crop_size
    log(f"[train] grad check, stage 3 ({sum(p.numel() for p in params.values()) / 1e6:.1f}M), "
        f"B=1, {crop}² crop of {size}²: card {s_card:.1f} s, cpu plain {s_cpu:.1f} s; forward "
        f"launches {launches} (the sites: {want})")
    require(launches == want, f"grad check launches {launches} != {want}")
    bad = [k for k, g in zip(names, g_card) if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    log(f"[train] parameters with a non-finite or zero gradient on the card: {len(bad)} of "
        f"{len(names)} {bad[:5]}")
    require(not bad, f"non-finite or zero gradients: {bad[:5]}")
    diff2 = sum(((a.double() - b.double()) ** 2).sum().item() for a, b in zip(g_card, g_cpu))
    ref2 = sum((b.double() ** 2).sum().item() for b in g_cpu)
    grad_err = math.sqrt(diff2 / ref2)
    per = sorted(((((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item(), k)
                  for k, a, b in zip(names, g_card, g_cpu)), reverse=True)
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"[train] loss card {l_card:.6f} cpu {l_cpu:.6f}: relative err {loss_err:.3e} "
        f"(tol {LOSS_TOL:.3e}); gradients normwise {grad_err:.3e} (tol {GRAD_TOL:.3e}); "
        f"per parameter: median {per[len(per) // 2][0]:.3e}, largest "
        + ", ".join(f"{k} {e:.3e}" for e, k in per[:3]) + f" [{smi}]")
    require(loss_err <= LOSS_TOL, f"loss card {l_card} vs cpu {l_cpu}")
    require(grad_err <= GRAD_TOL, f"gradients normwise {grad_err}")
    log(f"[train] grad check {time.perf_counter() - t0:.1f} s")
    return dict(loss_rel_err=loss_err, grad_normwise_err=grad_err,
                grad_per_param_max=per[0][0], card_s=s_card, cpu_s=s_cpu)


class PhaseClock:
    """CUDA events at a `Trainer`'s phase boundaries (its `phase_hook`)."""

    def __init__(self):
        self.marks = []

    def __call__(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def steps(self):
        """[(step ms, {phase: ms})] of the steps marked since the last call."""
        torch.cuda.synchronize()
        out, cur = [], []
        for name, ev in self.marks:
            cur.append((name, ev))
            if name == "end":
                phases = {}
                for (a, ea), (_, eb) in zip(cur, cur[1:]):
                    phases[a] = phases.get(a, 0.0) + ea.elapsed_time(eb)
                out.append((cur[0][1].elapsed_time(ev), phases))
                cur = []
        self.marks = []
        return out


def train_stage(cascade: Cascade, n: int, gen, smi: str):
    """TRAIN_STEPS[n] `Trainer.train_step`s of stage n at full width from the
    trainer's own initial state (Flax's initializers, zero final conv, from
    a seed drawn from `gen`), batch TRAIN_BATCH of 1024² images, one batch
    with the same draws every step (the trainer's generator reseeded), then
    one profiled step. Returns the trainer, the launches of one step and the
    numbers."""
    t0 = time.perf_counter()
    cfg = cascade.config
    steps = TRAIN_STEPS[n]
    clock = PhaseClock()
    seed = int(torch.randint(2**31 - 1, (1,), generator=gen, device="cuda").item())
    trainer = Trainer(cascade, only_train_unet_number=n, max_grad_norm=1.0, phase_hook=clock,
                      seed=seed)
    st = trainer.state(n)
    size = cfg.stage(3).image_size  # the dataset's patches, for every stage
    batch = {"images": torch.rand((TRAIN_BATCH, size, size, 3), generator=gen, device="cuda")}
    want = train_sites(cfg, n)
    leaf = "init_conv.kernel"
    losses, launches, walls, norms = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        trainer.generator.manual_seed(seed)  # the same draws every step
        ema_prev = st.ema_params[leaf].clone()
        zero_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(trainer.train_step(n, batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        launches.append(read_launches())
        norms.append(trainer.last_grad_norm)
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = clock.steps()
    n_self = sum(isinstance(m, SelfAttention) for m in build_model(cfg.stage(n).unet).modules())
    log(f"[train] stage {n}: losses {[f'{v:.5f}' for v in losses]}, global grad norms "
        f"{[f'{v:.4g}' for v in norms]}, launches per step {launches[0]} (the sites: {want}; "
        f"{n_self} of the attention sites self-attention)")
    require(all(math.isfinite(v) for v in losses + norms), f"stage {n}: non-finite loss or grads")
    require(trainer.num_steps_taken(n) == steps, f"{trainer.num_steps_taken(n)} steps taken")
    require(all(v == want for v in launches), f"stage {n} launches {launches} != {want}")
    require(min(launches[0][k] for k in ("conv3x3_wide", "conv3x3_narrow", "attention")) > 0,
            f"stage {n}: a kernel of the path did not launch: {launches[0]}")
    # the last step's EMA of one leaf: the warmup formula on the step's parameters
    d = ema_decay(trainer.ema_decay, steps - 1)
    one_minus = float(torch.tensor(1.0) - torch.tensor(d))
    expect = ema_prev * d + st.params[leaf].detach() * one_minus
    ema_err = ((st.ema_params[leaf] - expect).abs().max() / expect.abs().max()).item()
    log(f"[train] stage {n}: EMA of {leaf} after step {steps}: decay {d:.6f}, max rel err "
        f"{ema_err:.2e} against e * d + p * (1 - d) (bit-equal "
        f"{torch.equal(st.ema_params[leaf], expect)})")
    require(ema_err <= 2.0**-22, f"stage {n}: EMA {ema_err}")
    if n == 3:
        require(losses[-1] < losses[0], f"stage 3: loss did not fall on a fixed batch: {losses}")
    # device busy time and idle share: one more step, profiled
    from torch.profiler import ProfilerActivity, profile

    trainer.generator.manual_seed(seed)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(n, batch)
        torch.cuda.synchronize()
    clock.steps()
    kernels, dev_us = kernel_times(prof)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    later = timed[1:] or timed  # the first step builds the allocator's pools
    step_ms = sum(t for t, _ in later) / len(later)
    back_ms = sum(p.get("backward", 0.0) for _, p in later) / len(later)
    fwd_ms = sum(p.get("forward", 0.0) for _, p in later) / len(later)
    upd_ms = sum(p.get("update", 0.0) for _, p in later) / len(later)
    wall = sum(walls[1:] or walls) / len(walls[1:] or walls)
    nums = dict(batch=TRAIN_BATCH, steps=steps, step_ms=step_ms, forward_ms=fwd_ms,
                backward_ms=back_ms, update_ms=upd_ms, backward_share=back_ms / step_ms,
                wall_s=wall, busy_s=busy, idle_share=max(0.0, 1 - busy / wall),
                peak_gib=peak, first_step_ms=timed[0][0], losses=losses)
    log(f"[train] stage {n} ({smi}): {step_ms:.1f} ms/step [CUDA events, steps 2-{steps}]: "
        f"forward {fwd_ms:.1f}, backward {back_ms:.1f} ({back_ms / step_ms:.3f} of the step), "
        f"update {upd_ms:.1f}; first step {timed[0][0]:.1f} ms; wall {wall:.3f} s/step; device "
        f"busy {busy:.3f} s (profiled step), idle share {nums['idle_share']:.3f}; peak "
        f"{peak:.2f} GiB")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[train]   {dev_us(e) / 1e3:9.2f} ms {e.count:6d} calls  {e.key[:90]}")
    log(f"[train] stage {n} {time.perf_counter() - t0:.1f} s")
    return trainer, launches[0], nums


def phase_checkpoint(trainer: Trainer, n: int) -> dict:
    """`save` then `load` of stage n's state into a fresh trainer: full, then
    `ema_only` merged with `partial=True` over a perturbed EMA; bit-equal."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    log(f"[train] checkpoints under {root}: {shutil.disk_usage(root).free / 1e9:.1f} GB free")
    nums = {}
    with tempfile.TemporaryDirectory(prefix="ckpt_smoke_", dir=root) as tmp:
        back = Trainer(trainer.cascade, only_train_unet_number=n)
        for label, ema_only in (("full", False), ("ema_only", True)):
            path = Path(tmp) / label
            t1 = time.perf_counter()
            trainer.save(path, ema_only=ema_only)
            t2 = time.perf_counter()
            if ema_only:  # something for the merge to restore
                for v in back.state(n).ema_params.values():
                    v.zero_()
                back.state(n).step = 0
            back.load(path, partial=ema_only)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            got, ref = flatten(back.state(n).tree()), flatten(trainer.state(n).tree())
            same = got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
            gb = sum(f.stat().st_size for f in path.iterdir()) / 1e9
            log(f"[train] checkpoint {label}: {gb:.2f} GB, save {t2 - t1:.1f} s, load "
                f"{t3 - t2:.1f} s, {len(ref)} leaves bit-equal: {same}")
            require(same, f"checkpoint {label}: the restored state differs")
            nums[label] = dict(gb=gb, save_s=t2 - t1, load_s=t3 - t2)

            shutil.rmtree(path)
        del back
    log(f"[train] checkpoints {time.perf_counter() - t0:.1f} s")
    return nums


def phase_train(cascade: Cascade, gen, smi: str):
    """The training half of the flagship (see the module docstring)."""
    t0 = time.perf_counter()
    nums = {"grad_check": phase_grad_check(cascade, gen, smi)}
    launches = {}
    trainer, launches["train_3"], nums["stage3"] = train_stage(cascade, 3, gen, smi)
    nums["checkpoint"] = phase_checkpoint(trainer, 3)
    del trainer
    torch.cuda.empty_cache()
    trainer, launches["train_1"], nums["stage1"] = train_stage(cascade, 1, gen, smi)
    del trainer
    torch.cuda.empty_cache()
    log(f"[train] {time.perf_counter() - t0:.1f} s")
    return launches, nums


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile requests A and C stage by stage (torch.profiler)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    name, count, smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = phase_kernels(gen)
    probe_rows = phase_probe()

    t0 = time.perf_counter()
    flagship = ultra_res(0, "v_param")
    cascades = {"A": Cascade(flagship, device="cuda"),
                "C": Cascade(serving_overrides(flagship, quant="int8", storage="float8_e4m3fn"),
                             device="cuda")}
    cascade = cascades["A"]
    params = [cascade.init_stage_params(n, gen) for n in (1, 2, 3)]
    for ps in params:
        # Flax zero-initialises the final conv, which would make every U-Net
        # output 0; give it lecun-scaled weights so the output depends on
        # every layer
        k = ps["final_conv.kernel"]
        k.copy_(torch.randn(k.shape, generator=gen, device=k.device) / (9 * k.shape[2]) ** 0.5)
    # the loop's names would keep stage 3's weights past `params.clear()`
    del ps, k
    torch.cuda.synchronize()
    n_params = [sum(p.numel() for p in ps.values()) for ps in params]
    log(f"[init] flagship parameters from seed {args.seed} on the card: "
        f"{[f'{n / 1e6:.1f}M' for n in n_params]} = {sum(n_params) / 1e9:.3f}B fp32, "
        f"{time.perf_counter() - t0:.1f} s")

    phase_forward(cascade, params[0], gen)
    phase_quant_forward(cascades["C"], params[2], gen)
    launches, mag0 = phase_serve(cascades, params, gen)
    if args.profile:
        phase_profile(cascades, params, gen)
    params.clear()  # the serving weights; the gigapixel level and training draw their own
    torch.cuda.empty_cache()
    launches["G"], giga_nums = phase_gigapixel(mag0, gen, args.seed, smi)
    log("[gigapixel] summary " + json.dumps(dict(giga_nums, device=name, nvidia_smi=smi)))
    gc.collect()  # the level's records and hooked models hold closures (cycles)
    torch.cuda.empty_cache()
    log(f"[gigapixel] left allocated after the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    train_launches, train_nums = phase_train(cascade, gen, smi)
    launches.update(train_launches)
    log("[train] summary " + json.dumps(dict(train_nums, device=name, nvidia_smi=smi)))

    # each kernel's own launches: the WMMA kernel's bf16 and int8 modes have
    # none on a served path (held and timed through a forced route; its
    # bf16 count is G's, the path it served before the narrow kernel took
    # Cin up to 16)
    by_kernel = {k: per_kernel(v) for k, v in launches.items()}
    kernels = []
    for kname, source, replaces, path in (
            ("conv3x3_wide", WIDE_SOURCE, CONV_REPLACES, "A"),
            ("conv3x3_narrow", NARROW_SOURCE, CONV_REPLACES, "A"),
            ("conv3x3", CONV_SOURCE, CONV_REPLACES, "G"),
            ("conv3x3_int8_wide", WIDE_SOURCE, CONV_INT8_REPLACES, "C"),
            ("conv3x3_int8", CONV_SOURCE, CONV_INT8_REPLACES, "C"),
            ("attention", ATTN_SOURCE, ATTN_REPLACES, "A")):
        cases = rows[kname]
        # the first timed case is the main path's heaviest shape for the
        # kernel; the WMMA kernel's is WMMA_HEAD
        head = next(c for c in cases if "ms" in c and (kname != "conv3x3"
                                                        or c["case"] == WMMA_HEAD))
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=by_kernel[path][kname], max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            launches_by_request={k: v[kname] for k, v in by_kernel.items()}, cases=cases))
    for variant, row in probe_rows.items():
        kernels.append(dict(route="cuda", source=PROBE_SOURCE, replaces=PROBE_REPLACES, **row))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()

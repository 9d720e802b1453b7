"""Probe: the conv kernel's tap product in int8 against bf16 on the card.

Port of `tools/probe_int8_pallas.py`, the gate experiment for an int8 conv
path: nine accumulated (M x K) . (K x N) products at the flagship conv
tile shape (M = 8192 pixels, K = N = 128 channels, 9 taps), in three forms
(`VARIANTS`): bf16 operands with fp32 sums; int8 operands with int32 sums
(scaled by 1e-4); and bf16 x quantized inside the kernel by a scalar scale
s, then int8 (scaled by s * 1e-2). Each runs REPS back-to-back launches of
the hand-written kernel (`kernels/csrc/probe_int8.cu`) between two CUDA
events, and one JSON line per variant reports the time per call and the
effective rate:

    python -m kidney_diffusion_tpu_torch.tools.probe_int8 [--device cuda] [--reps 64]

The inputs are the original's: numpy draws from seed 0 in the same order.
`--device cpu` runs the plain versions instead (host timings, labelled
with the device). Importing this module builds nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import _build

Tensor = torch.Tensor

M, K, N = 8 * 1024, 128, 128  # one row tile of the 1024² stage
TAPS = 9
REPS = 64
VARIANTS = ("bf16_dot", "int8_dot", "int8_quantize_dot")
_FORM = {name: i for i, name in enumerate(VARIANTS)}

# launches of each variant's CUDA kernel since the counts were last set to 0
LAUNCHES: Dict[str, int] = {name: 0 for name in VARIANTS}

_P = ctypes.c_void_p
_I = ctypes.c_int


def ops_per_call(m: int = M, k: int = K, n: int = N, taps: int = TAPS) -> float:
    """Multiply-adds counted as two operations, as the original counts them."""
    return 2.0 * m * k * n * taps


def make_inputs(device="cuda", seed: int = 0) -> Dict[str, tuple]:
    """The original's inputs (`tools/probe_int8_pallas.py:main`): one numpy
    generator drawn in the order bf16, int8, quantize."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bf16 = lambda a: torch.from_numpy(a).float().to(dev, torch.bfloat16)  # noqa: E731
    int8 = lambda a: torch.from_numpy(a).to(dev, torch.int8)  # noqa: E731
    x = bf16(rng.normal(size=(M, K)))
    w = bf16(rng.normal(size=(TAPS, K, N)) * 0.1)
    out = {"bf16_dot": (x, w)}
    x = int8(rng.integers(-127, 127, (M, K)))
    w = int8(rng.integers(-127, 127, (TAPS, K, N)))
    out["int8_dot"] = (x, w)
    x = bf16(rng.normal(size=(M, K)))
    w = int8(rng.integers(-127, 127, (TAPS, K, N)))
    out["int8_quantize_dot"] = (x, w, torch.full((1,), 0.031, dtype=torch.float32, device=dev))
    return out


def probe_plain(variant: str, x: Tensor, w: Tensor, s: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of one variant. bf16 products in fp32, summed
    tap by tap in fp32; int8 products in float64, where the int32 sums are
    exact; each scale applied as its own fp32 multiply."""
    if variant == "bf16_dot":
        acc = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32, device=x.device)
        for t in range(w.shape[0]):
            acc += x.float() @ w[t].float()
        return acc.to(torch.bfloat16)
    if variant == "int8_dot":
        deq = torch.tensor(1e-4, dtype=torch.float32, device=x.device)
        xq = x.double()
    elif variant == "int8_quantize_dot":
        s = s.float().reshape(())
        deq = s * torch.tensor(1e-2, dtype=torch.float32, device=x.device)
        xq = torch.clamp(torch.round(x.float() / s), -127, 127).double()
    else:
        raise ValueError(f"unknown variant {variant!r}; have {VARIANTS}")
    acc = sum(xq @ w[t].double() for t in range(w.shape[0]))
    return (acc.float() * deq).to(torch.bfloat16)


def _lib():
    lib = _build.library("probe_int8")
    if lib.kdt_probe_int8.argtypes is None:
        lib.kdt_probe_int8.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.kdt_probe_int8.restype = _I
    return lib


def probe_cuda(variant: str, x: Tensor, w: Tensor, s: Optional[Tensor] = None) -> Tensor:
    """Launch the variant's CUDA kernel; raises on shapes or types it does
    not take."""
    if variant not in _FORM:
        raise ValueError(f"unknown variant {variant!r}; have {VARIANTS}")
    m, k = x.shape
    taps, k2, n = w.shape
    want = {"bf16_dot": (torch.bfloat16, torch.bfloat16), "int8_dot": (torch.int8, torch.int8),
            "int8_quantize_dot": (torch.bfloat16, torch.int8)}[variant]
    if (x.dtype, w.dtype) != want:
        raise TypeError(f"{variant} takes x {want[0]} and w {want[1]}, got {x.dtype}, {w.dtype}")
    if k2 != k or m % 64 or n % 64 or k % 16 or k > 128:
        raise ValueError(f"{variant}: x {tuple(x.shape)}, w {tuple(w.shape)} not supported")
    if variant == "int8_quantize_dot" and (s is None or s.numel() != 1 or s.dtype != torch.float32):
        raise ValueError("int8_quantize_dot needs a one-element fp32 scale s")
    x, w = _build.aligned(x), _build.aligned(w)
    o = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    rc = lib.kdt_probe_int8(_FORM[variant], x.data_ptr(), w.data_ptr(),
                            s.data_ptr() if s is not None else None, o.data_ptr(), m, k, n, taps,
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"probe {variant}")
    LAUNCHES[variant] += 1
    return o


def probe(variant: str, x: Tensor, w: Tensor, s: Optional[Tensor] = None) -> Tensor:
    """One call of a variant: the plain version for CPU tensors, the CUDA
    kernel for tensors on the card."""
    if x.device.type == "cpu":
        return probe_plain(variant, x, w, s)
    if x.device.type != "cuda":
        raise ValueError(f"the probe runs on the CPU or a CUDA device, not {x.device}")
    return probe_cuda(variant, x, w, s)


def time_us(fn, reps: int, cuda: bool) -> float:
    """Microseconds per call over `reps` back-to-back calls after a warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` reports them (a card
    below its 700 W maximum runs slower under load), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def run(device="cuda", reps: int = REPS, seed: int = 0) -> List[dict]:
    """Time every variant; print and return one record per variant."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    name = card_name(dev)
    inputs = make_inputs(dev, seed)
    results = []
    for variant in VARIANTS:
        args = inputs[variant]
        us = time_us(lambda: probe(variant, *args), reps, cuda)
        rec = {"variant": variant, "us_per_call": us,
               "effective_tops": ops_per_call() / (us * 1e-6) / 1e12, "device": name}
        print(json.dumps(rec), flush=True)
        results.append(rec)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.device, args.reps, args.seed)


if __name__ == "__main__":
    main()

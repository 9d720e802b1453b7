"""Device time of the served configs' init convs on the card, on the kernel
`kernels.conv3x3.route` picks, beside `F.conv2d` and the bytes bound.

    python -m kidney_diffusion_tpu_torch.tools.bench_narrow [--iters 50] [--label NAME]

The shapes are the init convs as the served U-Nets call them (Cin 6 and 3
of the flagship, 9, 10 and 12 of the conditioned stages; stage 3 chunked
with its range epilogue, stages 1-2 unchunked with the bf16 bias rounding).
Inputs are drawn from a fixed seed on the card; each output is held to its
plain version (2 bf16 ulps of the largest value, 2^-8 normwise) before it is
timed: `iters` calls captured in a CUDA graph, replayed once to warm it and
once timed by CUDA events. One JSON line per case, then the card's name and
power limit.

It imports the package by absolute name, so run by path with PYTHONPATH set
to a checkout it times that checkout's kernels: two commits compare in one
call by running it on each in turn (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from kidney_diffusion_tpu_torch.kernels import conv3x3 as conv_mod

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
# name: (batch*chunks, rows, width, cin, cout, chunks, range, bias_in_dtype)
CASES = {
    "stage3_cin6": (16, 64, 1024, 6, 128, 16, False, False),
    "stage3_cin6_range": (16, 64, 1024, 6, 128, 16, True, False),
    "stage1_cin3": (1, 64, 64, 3, 256, 0, False, True),
    "stage2_cin6": (1, 256, 256, 6, 128, 0, False, True),
    "stage1_cin6_batch8": (8, 64, 64, 6, 256, 0, False, True),
    "stage3_cin9_range": (16, 64, 1024, 9, 128, 16, True, False),
    "stage2_cin9": (1, 256, 256, 9, 128, 0, False, True),
    "stage2_cin9_batch8": (8, 256, 256, 9, 128, 0, False, True),
    "v2_stage2_cin12": (1, 256, 256, 12, 128, 0, False, True),
    "v2_stage3_cin12_range": (16, 64, 1024, 12, 128, 16, True, False),
    "patch_conditioned_stage2_cin10": (1, 256, 256, 10, 128, 0, False, True),
    "v2_stage1_cin9_batch8": (8, 64, 64, 9, 256, 0, False, True),
}


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, by CUDA-graph replay."""
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
    return start.elapsed_time(end) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_narrow times kernels on the card; no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, (nb, h, w, cin, cout, chunks, rng_, bid) in CASES.items():
        x = torch.randn((nb, h, w, cin), generator=gen, device=dev).bfloat16()
        wk = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) / (9 * cin) ** 0.5).bfloat16()
        b = torch.randn((cout,), generator=gen, device=dev)
        kw = dict(chunks=chunks, want_range=rng_, bias_in_dtype=bid)
        got = conv_mod.conv3x3(x, wk, b, **kw)
        ref = conv_mod.conv3x3_plain(x, wk, b, **kw)
        got, ref = (got[0], ref[0]) if rng_ else (got, ref)
        diff = (got.double() - ref.double()).abs()
        scale = ref.double().abs().max().item()
        norm = (diff.norm() / ref.double().norm()).item()
        if diff.max().item() > 2 * 2.0**-7 * scale or norm > 2.0**-8:
            raise AssertionError(f"{case}: kernel disagrees with its plain version ({norm:.2e})")
        iters = 20 if nb * h * w * cin * cout > 1e9 else args.iters
        ms = time_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
        xl = x.reshape(nb // max(chunks, 1), h * max(chunks, 1), w, cin).permute(0, 3, 1, 2)
        xl, wl = xl.contiguous(), wk.permute(3, 2, 0, 1).contiguous()
        lib_ms = time_ms(lambda: F.conv2d(xl, wl, b.bfloat16(), padding=1), iters)
        n_bytes = 2.0 * (x.numel() + wk.numel() + nb * h * w * cout) + 4.0 * cout
        bound = (n_bytes + 8.0 * nb * cout * rng_) / PEAK_BYTES * 1e3
        print(json.dumps(dict(label=args.label, case=case, kernel=conv_mod.route(cin, cout, False, bid),
                              ms=ms, library_ms=lib_ms, bound_ms=bound, share=bound / ms,
                              normwise_err=norm, device=smi)), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kidney_diffusion_tpu_torch`) on one
NVIDIA card: the quickest proof that the port starts and is right there.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, each printing its own lines and seconds:

1. device: the card's name, the device count, and `nvidia-smi`'s name and
   power limit;
2. build: nvcc compiles every kernel of the main path (`kernels/csrc/*.cu`,
   sm_90a, plain C interface, loaded with ctypes), all in parallel;
3. kernels: each kernel's wrapper on card tensors at the flagship shapes,
   held against its plain PyTorch version on the same inputs with the
   stated tolerances, and timed (CUDA events) beside the plain version and
   one PyTorch library call as a yardstick;
4. forward: a full-width stage-1 U-Net forward through the kernels on the
   card against the plain path on the CPU, same weights and inputs;
5. serve: the flagship `ultra_res(0, "v_param")` cascade at full width,
   weights made on the card from --seed, answers (A) one 1024² patch at the
   shipped serving mix dpmpp_steps=(25, 25, 0), ddim_steps=(0, 0, 4) and
   (B) a batch of 2 from stage 1 alone on its ancestral loop cut to 8 steps,
   through `Cascade.sample`. Launch counts are zeroed just before each
   request and read just after; they must equal one launch per 3x3 conv
   and per attention layer of every U-Net forward, so every such layer of
   the path ran its kernel;
6. with `--profile` only: request A again stage by stage under
   torch.profiler (device busy time, idle share, top kernels).

Then one JSON line with every kernel's numbers, the `nvidia-smi` line, and
last `{"ok": true, "device": {...}}`. Any failed check raises, so the script
exits non-zero and prints no result; without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from kidney_diffusion_tpu_torch.cascade import Cascade
from kidney_diffusion_tpu_torch.convert import build_model
from kidney_diffusion_tpu_torch.kernels import _build
from kidney_diffusion_tpu_torch.kernels import attention as attn_mod
from kidney_diffusion_tpu_torch.kernels import conv3x3 as conv_mod
from kidney_diffusion_tpu_torch.models.blocks import Conv3x3, CrossAttention, SelfAttention
from kidney_diffusion_tpu_torch.models.configs import ultra_res
from kidney_diffusion_tpu_torch.models.unet import EfficientUNet

# request A: the shipped serving mix; (stage, sampler steps = U-Net forwards)
SERVE_A = dict(dpmpp_steps=(25, 25, 0), ddim_steps=(0, 0, 4))
FORWARDS_A = ((1, 25), (2, 25), (3, 4))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_ULP = 2.0**-7  # spacing of bf16 values in [1, 2)

CONV_SOURCE = "kidney_diffusion_tpu_torch/kernels/csrc/conv3x3.cu"
CONV_REPLACES = "kidney_diffusion_tpu/kernels/conv3x3.py:394"
ATTN_SOURCE = "kidney_diffusion_tpu_torch/kernels/csrc/attention.cu"
ATTN_REPLACES = "kidney_diffusion_tpu/kernels/attention.py:68"

# name: (batch*chunks, rows, width, cin, cout, chunks, prologue, stats)
CONV_CASES = {
    "a_stage3_chunked_512": (16, 32, 512, 128, 128, 16, True, True),
    "b_stage3_init_conv": (16, 64, 1024, 6, 128, 16, False, False),
    "c_stage1_16x16_768": (1, 16, 16, 768, 768, 0, True, True),
    "d_stage3_final_conv": (16, 64, 1024, 128, 3, 16, False, False),
    "e_stage3_skip_concat_64": (16, 4, 64, 2048, 1024, 16, True, True),
}
# name: (batch, nq, nk, heads, dim_head)
ATTN_CASES = {
    "self_1024_plus_2": (1, 1024, 1026, 8, 64),
    "cross_4096_4": (1, 4096, 4, 8, 64),
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


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call, by CUDA events, after a warm-up."""
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_build():
    t0 = time.perf_counter()
    seconds = _build.build(["conv3x3", "attention"])
    for name, report in _build.PTXAS_REPORTS.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    conv_mod._lib(), attn_mod._lib()  # load both libraries through ctypes
    log(f"[build] nvcc sm_90a -> ctypes: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    log(f"[build] {time.perf_counter() - t0:.1f} s")


def phase_kernels(gen):
    """Every kernel against its plain version at the flagship shapes."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False  # the plain versions run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {"conv3x3": [], "attention": []}

    for case, (nb, h, w, cin, cout, chunks, pro, stats) in CONV_CASES.items():
        x = torch.randn((nb, h, w, cin), generator=gen, device=dev).bfloat16()
        wk = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
              / (9 * cin) ** 0.5).bfloat16()
        b = torch.randn((cout,), generator=gen, device=dev)
        p = None
        if pro:  # per-image affine repeated over its chunks, as GroupNorm makes it
            n_img = nb // max(chunks, 1)
            p = torch.randn((n_img, 2, cin), generator=gen, device=dev)
            p[:, 0] = p[:, 0].abs() + 0.5
            p = p.repeat_interleave(max(chunks, 1), dim=0)
        kw = dict(pro=p, want_stats=stats, chunks=chunks)
        got = conv_mod.conv3x3(x, wk, b, **kw)
        ref = conv_mod.conv3x3_plain(x, wk, b, **kw)
        torch.cuda.synchronize()
        got, ref = (got, ref) if stats else ((got,), (ref,))
        log(f"[kernels] conv3x3 {case}: x {tuple(x.shape)} -> {cout}, chunks={chunks}, "
            f"prologue={pro}, stats={stats}")
        err = check("y", got[0].float(), ref[0].float(), CONV_TOL["y"])
        if stats:
            check("stats", got[1], ref[1], CONV_TOL["stats"])
        iters = 20 if nb * h * w * cin * cout > 1e9 else 50
        ms = time_ms(lambda: conv_mod.conv3x3_cuda(x, wk, b, **kw), iters)
        plain_ms = time_ms(lambda: conv_mod.conv3x3_plain(x, wk, b, **kw), iters)
        full_h = h * max(chunks, 1)
        xl = x.reshape(nb // max(chunks, 1), full_h, w, cin).permute(0, 3, 1, 2).contiguous()
        wl = wk.permute(3, 2, 0, 1).contiguous()
        lib_ms = time_ms(lambda: F.conv2d(xl, wl, b.bfloat16(), padding=1), iters)
        n_ops = 2.0 * nb * h * w * 9 * cin * cout
        n_bytes = 2.0 * (x.numel() + wk.numel() + nb * h * w * cout) + 4.0 * cout
        n_bytes += 4.0 * (p.numel() if p is not None else 0) + (8.0 * nb * cout if stats else 0)
        bms, by = bound_ms(n_bytes, n_ops)
        log(f"  ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(F.conv2d NCHW bf16)={lib_ms:.4f} "
            f"bound_ms={bms:.4f} ({by}) -> {n_ops / ms / 1e9:.1f} TFLOP/s")
        rows["conv3x3"].append(dict(case=case, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bms, bound_by=by, library_ms=lib_ms))

    for case, (b, nq, nk, hh, d) in ATTN_CASES.items():
        q, k, v = (torch.randn((b, n, hh, d), generator=gen, device=dev).bfloat16()
                   for n in (nq, nk, nk))
        got = attn_mod.attention(q, k, v)
        ref = attn_mod.attention_plain(q, k, v)
        torch.cuda.synchronize()
        log(f"[kernels] attention {case}: q {tuple(q.shape)} k/v {tuple(k.shape)}")
        err = check("o", got.float(), ref.float(), ATTN_TOL)
        ms = time_ms(lambda: attn_mod.attention_cuda(q, k, v), 50)
        plain_ms = time_ms(lambda: attn_mod.attention_plain(q, k, v), 50)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), 50)
        n_ops = 4.0 * b * hh * nq * nk * d
        n_bytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bms, by = bound_ms(n_bytes, n_ops)
        log(f"  ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(sdpa)={lib_ms:.4f} "
            f"bound_ms={bms:.4f} ({by})")
        rows["attention"].append(dict(case=case, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bms, bound_by=by, library_ms=lib_ms))
    log(f"[kernels] {time.perf_counter() - t0:.1f} s")
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


def expected_launches(cfg, forwards) -> dict:
    """Kernel launches that `forwards` U-Net calls per stage must make: one
    per Conv3x3 module (every 3x3 conv) and one per attention module."""
    counts = {"conv3x3": 0, "attention": 0}
    for n, fwd in forwards:
        mods = list(build_model(cfg.stage(n).unet).modules())
        counts["conv3x3"] += fwd * sum(isinstance(m, Conv3x3) for m in mods)
        counts["attention"] += fwd * sum(isinstance(m, (SelfAttention, CrossAttention))
                                         for m in mods)
    return counts


def phase_profile(cascade: Cascade, params, gen):
    """Request A stage by stage: wall seconds (unprofiled), device busy time
    from a second, profiled run, the idle share 1 - busy / wall, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            img = run()
        # device kernels only: CPU-side ops report their kernels' time again
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
            e, "self_cuda_time_total", 0)
        busy = sum(dev_us(e) for e in kernels) / 1e6
        log(f"[profile] stage {n}: {steps} steps, wall {wall:.3f} s "
            f"({wall / steps * 1e3:.1f} ms/step), device busy {busy:.3f} s, "
            f"idle share {max(0.0, 1 - busy / wall):.3f}")
        for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
            log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms {e.count:6d} calls  {e.key[:90]}")


def phase_serve(cascade: Cascade, params, gen):
    t0 = time.perf_counter()
    cfg = cascade.config
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    n_fwd = [0]

    def finite_hook(module, args, output):  # every U-Net output must be finite
        if isinstance(module, EfficientUNet):
            bad.add_((~torch.isfinite(output)).sum())
            n_fwd[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(finite_hook)
    try:
        # (A) one 1024² patch at the shipped serving mix
        conv_mod.LAUNCHES = attn_mod.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = cascade.sample(params, gen, batch_size=1, output_dtype="uint8", **SERVE_A)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        launches = {"conv3x3": conv_mod.LAUNCHES, "attention": attn_mod.LAUNCHES}
        log(f"[serve] A: {sec:.2f} s, out {tuple(out.shape)} {out.dtype} "
            f"range [{out.min().item()}, {out.max().item()}] mean {out.float().mean().item():.2f}, "
            f"unet forwards {n_fwd[0]}, non-finite unet outputs {bad.item()}, "
            f"launches conv3x3={launches['conv3x3']} attention={launches['attention']}, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(tuple(out.shape) == (1, 1024, 1024, 3) and out.dtype == torch.uint8, str(out.shape))
        require(bad.item() == 0 and n_fwd[0] == sum(f for _, f in FORWARDS_A),
                f"non-finite outputs {bad.item()}, forwards {n_fwd[0]}")
        # every conv3x3 and attention site of every forward went through its kernel
        want = expected_launches(cfg, FORWARDS_A)
        log(f"[serve] A: launches expected from the model's layers: {want}")
        require(launches == want and min(launches.values()) > 0, str((launches, want)))

        # (B) stage 1 alone, ancestral loop cut to 8 steps, batch 2
        cfg_b = dataclasses.replace(
            cfg, stages=(dataclasses.replace(cfg.stage(1), timesteps=8),) + cfg.stages[1:])
        cascade_b = Cascade(cfg_b, device="cuda")
        conv_mod.LAUNCHES = attn_mod.LAUNCHES = 0
        n_fwd[0] = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out_b = cascade_b.sample(params, gen, batch_size=2, stop_at_unet_number=1)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        log(f"[serve] B: {sec:.2f} s, out {tuple(out_b.shape)} {out_b.dtype} "
            f"range [{out_b.min().item():.4f}, {out_b.max().item():.4f}], "
            f"finite {torch.isfinite(out_b).all().item()}, unet forwards {n_fwd[0]}, "
            f"non-finite unet outputs {bad.item()}, launches conv3x3={conv_mod.LAUNCHES} "
            f"attention={attn_mod.LAUNCHES}, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(tuple(out_b.shape) == (2, 64, 64, 3) and torch.isfinite(out_b).all().item(),
                f"request B output {tuple(out_b.shape)}")
        require(0.0 <= out_b.min().item() and out_b.max().item() <= 1.0, "request B range")
        require(bad.item() == 0 and n_fwd[0] == 8,
                f"non-finite outputs {bad.item()}, forwards {n_fwd[0]}")
        want = expected_launches(cfg, ((1, 8),))
        require({"conv3x3": conv_mod.LAUNCHES, "attention": attn_mod.LAUNCHES} == want, str(want))
    finally:
        hook.remove()
    log(f"[serve] {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile request A stage by stage (torch.profiler)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    name, count, smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = phase_kernels(gen)

    t0 = time.perf_counter()
    cascade = Cascade(ultra_res(0, "v_param"), device="cuda")
    params = [cascade.init_stage_params(n, gen) for n in (1, 2, 3)]
    for ps in params:
        # Flax zero-initialises the final conv, which would make every U-Net
        # output 0; give it lecun-scaled weights so the output depends on
        # every layer
        k = ps["final_conv.kernel"]
        k.copy_(torch.randn(k.shape, generator=gen, device=k.device) / (9 * k.shape[2]) ** 0.5)
    torch.cuda.synchronize()
    n_params = [sum(p.numel() for p in ps.values()) for ps in params]
    log(f"[init] flagship parameters from seed {args.seed} on the card: "
        f"{[f'{n / 1e6:.1f}M' for n in n_params]} = {sum(n_params) / 1e9:.3f}B fp32, "
        f"{time.perf_counter() - t0:.1f} s")

    phase_forward(cascade, params[0], gen)
    launches = phase_serve(cascade, params, gen)
    if args.profile:
        phase_profile(cascade, params, gen)

    kernels = []
    for kname, source, replaces in (("conv3x3", CONV_SOURCE, CONV_REPLACES),
                                    ("attention", ATTN_SOURCE, ATTN_REPLACES)):
        cases = rows[kname]
        head = cases[0]  # the first case is the main path's heaviest shape
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"], cases=cases))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()

"""Demo / inspection gigapixel sampler: a mag-1 refinement limited to a few
patches (a 2x2 grid by default) that dumps every intermediate (per-patch
cond images, inpaint strips and masks, per-stage outputs) for inspecting
the seam blending, optionally looping several full generations.

    python -m kidney_diffusion_tpu_torch.cli.sample_ultra_res_demo \\
        --ckpt_mag0 ... --ckpt_mag1 ... --version v_param

The port of `kidney_diffusion_tpu/cli/sample_ultra_res_demo.py`, with
`--device` added (default "cuda").
"""

from __future__ import annotations

import argparse
import os
from uuid import uuid4

import numpy as np
import torch

from ..data.wsi import AIRS_MAG_LEVEL_SIZES, MAG_LEVEL_SIZES
from ..sample.gigapixel import generate_high_res_image
from ..utils.logging import save_image
from .sample_ultra_res import load_level_params


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt_mag0", type=str, required=True)
    p.add_argument("--ckpt_mag1", type=str, required=True)
    p.add_argument("--version", type=str, default="v1",
                   choices=("v1", "v2", "v_param", "airs"))
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--inpaint_resample", type=int, default=1)
    p.add_argument("--sample_dir", type=str, default="samples_demo")
    p.add_argument("--max_patches", type=int, default=4)
    p.add_argument("--loops", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quant", type=str, default="int8", choices=("int8", "none"))
    p.add_argument("--activation_storage", type=str, default="float8_e4m3fn",
                   choices=("float8_e4m3fn", "float8_e5m2", "none"))
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on ('cuda', or 'cpu' for the plain path)")
    args = p.parse_args(argv)
    quant = None if args.quant == "none" else args.quant
    storage = None if args.activation_storage == "none" else args.activation_storage

    os.makedirs(args.sample_dir, exist_ok=True)
    airs = args.version == "airs"
    mag_sizes = AIRS_MAG_LEVEL_SIZES if airs else MAG_LEVEL_SIZES
    level_kw = dict(quant=quant, storage=storage, device=args.device)
    cascade0, params0 = load_level_params(args.ckpt_mag0, 0, args.version, **level_kw)
    cascade1, params1 = load_level_params(args.ckpt_mag1, 1, args.version, **level_kw)
    gen = torch.Generator(device=cascade0.device).manual_seed(args.seed)

    for loop in range(args.loops):
        run_dir = os.path.join(args.sample_dir, uuid4().hex[:8])
        os.makedirs(run_dir, exist_ok=True)
        mag0 = cascade0.sample(params0, gen, batch_size=1)[0].cpu().numpy()
        save_image(mag0, f"{run_dir}/MAG0.jpg")
        mag1 = generate_high_res_image(
            cascade1, params1, gen, mag0.astype(np.float32), 1,
            overlap=args.overlap, mag_sizes=mag_sizes,
            center_cond=(args.version == "v2"), airs=airs,
            inpaint_resample_times=args.inpaint_resample,
            max_patches=args.max_patches,
            debug_dir=os.path.join(run_dir, "artifacts"),
        )
        save_image(mag1, f"{run_dir}/MAG1.jpg")
        print(f"[demo] loop {loop + 1}/{args.loops}: artifacts in {run_dir}/", flush=True)


if __name__ == "__main__":
    main()

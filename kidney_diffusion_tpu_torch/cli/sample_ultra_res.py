"""Gigapixel WSI sampler: generate a mag-0 whole-slide overview, then refine
it to mag 1 and mag 2 with the wavefront orchestrator
(`sample/gigapixel.py`), on one card.

    python -m kidney_diffusion_tpu_torch.cli.sample_ultra_res \\
        --ckpt_mag0 ... --ckpt_mag1 ... --ckpt_mag2 ... \\
        --overlap 0.25 --version v_param \\
        --dpmpp_steps 25 25 0 --ddim_steps 0 0 4

Checkpoints are the port's (`Trainer.save`, full or `ema_only`), one per
magnification level holding its stages, or a comma-separated list of
per-stage checkpoints; only their EMA weights are read. The flags and defaults are those of
`kidney_diffusion_tpu/cli/sample_ultra_res.py`, with `--device` added
(default "cuda"; "cpu" runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import os
from uuid import uuid4

import numpy as np
import torch

from ..cascade import Cascade
from ..convert import init_stage_params
from ..data.wsi import AIRS_MAG_LEVEL_SIZES, MAG_LEVEL_SIZES
from ..models.configs import serving_overrides, ultra_res
from ..sample.gigapixel import generate_high_res_image
from ..utils.checkpoint import load_checkpoint, load_metadata
from ..utils.logging import save_image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt_mag0", type=str, required=True)
    p.add_argument("--ckpt_mag1", type=str, required=True)
    p.add_argument("--ckpt_mag2", type=str, required=True)
    p.add_argument("--version", type=str, default="v1",
                   choices=("v1", "v2", "v_param", "airs"))
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--inpaint_resample", type=int, default=1)
    p.add_argument("--sample_dir", type=str, default="samples")
    p.add_argument("--ignore_unet_1", action="store_true")
    p.add_argument("--max_wave_batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--stop_at_mag", type=int, default=2)
    p.add_argument("--dpmpp_steps", type=int, nargs="+", default=0,
                   help="DPM-Solver++(2M) steps; one value for all stages or one per stage "
                        "(0 disables; beats --ddim_steps per stage)")
    p.add_argument("--ddim_steps", type=int, nargs="+", default=0,
                   help="DDIM steps; one value for all stages or one per stage (0 disables; "
                        "e.g. the serving mix --dpmpp_steps 25 25 0 --ddim_steps 0 0 4)")
    p.add_argument("--wire", type=str, default="resident",
                   choices=["resident", "uint8", "fp32"],
                   help="host<->device transport: 'resident' keeps the level on the card "
                        "(canvas uploaded once, strips assembled there, only finished patches "
                        "copied back); 'uint8' / 'fp32' stage conditioning on the host")
    p.add_argument("--all_patches", action="store_true",
                   help="disable the mag-2 tissue filter and generate the full patch grid "
                        "(for non-histology content or untrained weights)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="cards to shard wave batches over; only 1 so far")
    p.add_argument("--quant", type=str, default="int8", choices=("int8", "none"),
                   help="w8a8 int8 serving mode for the >=512 stages (default on; "
                        "'none' = exact bf16)")
    p.add_argument("--activation_storage", type=str, default="float8_e4m3fn",
                   choices=("float8_e4m3fn", "float8_e5m2", "none"),
                   help="narrow activation storage for the >=512 stages (default on; "
                        "'none' = bf16 storage)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on ('cuda', or 'cpu' for the plain path)")
    args = p.parse_args(argv)
    args.quant = None if args.quant == "none" else args.quant
    args.activation_storage = (
        None if args.activation_storage == "none" else args.activation_storage
    )
    return args


def load_level_params(ckpt: str, mag: int, version: str, quant=None, storage=None,
                      device="cuda"):
    """(cascade, EMA params per stage) of one magnification level. `ckpt` is
    one checkpoint holding the level's stages, or a comma-separated list of
    per-stage checkpoints. Only the EMA weights reach the device."""
    config = serving_overrides(ultra_res(mag, version), quant=quant, storage=storage)
    cascade = Cascade(config, device=device)
    params = {}
    for path in ckpt.split(","):
        path = path.strip()
        target = {str(n): {"ema_params": init_stage_params(config, int(n), device="meta")}
                  for n in load_metadata(path).get("stages", [])}
        for n, tree in load_checkpoint(path, target, map_location="cpu").items():
            params[int(n)] = {k: v.to(cascade.device) for k, v in tree["ema_params"].items()}
    missing = [n for n in range(1, config.num_stages + 1) if n not in params]
    if missing:
        raise ValueError(f"no checkpoint in {ckpt!r} holds stages {missing}")
    return cascade, [params[n] for n in range(1, config.num_stages + 1)]


def main(argv=None):
    args = parse_args(argv)
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            "sharding wave batches over several cards is not ported yet "
            "(ROADMAP Queue 1 item 9, parallel)")
    os.makedirs(args.sample_dir, exist_ok=True)
    sample_id = uuid4().hex[:8]
    postfix = "" if not args.version else "-" + args.version
    airs = args.version == "airs"
    mag_sizes = AIRS_MAG_LEVEL_SIZES if airs else MAG_LEVEL_SIZES

    seed = args.seed if args.seed is not None else np.random.randint(2**31)
    level_kw = dict(quant=args.quant, storage=args.activation_storage, device=args.device)
    wire = None if args.wire == "fp32" else args.wire
    common = dict(
        overlap=args.overlap, mag_sizes=mag_sizes,
        center_cond=(args.version == "v2"), airs=airs,
        inpaint_resample_times=args.inpaint_resample,
        ignore_stage_1=args.ignore_unet_1,
        max_wave_batch=args.max_wave_batch,
        ddim_steps=args.ddim_steps,
        dpmpp_steps=args.dpmpp_steps,
        wire=wire,
    )

    # mag 0: one full-cascade patch, unconditional
    cascade0, params0 = load_level_params(args.ckpt_mag0, 0, args.version, **level_kw)
    gen = torch.Generator(device=cascade0.device).manual_seed(seed)
    mag0 = cascade0.sample(params0, gen, batch_size=1)[0].cpu().numpy()
    save_image(mag0, f"{args.sample_dir}/MAG0-{sample_id}{postfix}.jpg")
    print(f"MAG0 saved ({mag0.shape})", flush=True)
    del cascade0, params0
    if args.stop_at_mag < 1:
        return

    # mag 1: refine the overview
    cascade1, params1 = load_level_params(args.ckpt_mag1, 1, args.version, **level_kw)
    mag1 = generate_high_res_image(cascade1, params1, gen, mag0.astype(np.float32), 1,
                                   **common)
    save_image(mag1, f"{args.sample_dir}/MAG1-{sample_id}{postfix}.jpg")
    print(f"MAG1 saved ({mag1.shape})", flush=True)
    del cascade1, params1
    if args.stop_at_mag < 2:
        return

    # mag 2: refine to native resolution (tissue-filtered patches)
    cascade2, params2 = load_level_params(args.ckpt_mag2, 2, args.version, **level_kw)
    mag2 = generate_high_res_image(cascade2, params2, gen,
                                   mag1.astype(np.float32) / 255.0, 2,
                                   all_patches=args.all_patches, **common)
    save_image(mag2, f"{args.sample_dir}/MAG2-{sample_id}{postfix}.jpg")
    print(f"MAG2 saved ({mag2.shape})", flush=True)


if __name__ == "__main__":
    main()

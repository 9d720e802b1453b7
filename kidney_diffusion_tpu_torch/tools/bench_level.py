"""Wall time of one whole gigapixel level on each transport of the port.

    python -m kidney_diffusion_tpu_torch.tools.bench_level [--runs 3] [--seed 0]

Runs `generate_high_res_image` on the mag-1 level of `ultra_res(1, "v_param")`
with the CLI's defaults (`serving_overrides(quant="int8",
storage="float8_e4m3fn")`, overlap 0.25, the serving mix dpmpp_steps=(25,
25, 0), ddim_steps=(0, 0, 4)): an 8 x 8 grid of 1024² patches from a 1024²
coarse image, here uniform noise drawn from --seed, with weights drawn from
--seed on the card. Each run samples the whole level on `wire="uint8"` and
on `wire="resident"`, in the order uint8, resident on even runs and
resident, uint8 on odd ones, after one untimed four-patch level on each
wire. One JSON line per level, then a summary line with each wire's walls,
their mean and spread, and the ratio of the means.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..cascade import Cascade
from ..models.configs import serving_overrides, ultra_res
from ..sample.gigapixel import generate_high_res_image, get_cond_images

WIRES = ("uint8", "resident")
LEVEL = dict(overlap=0.25, inpaint_resample_times=1, max_wave_batch=32,
             dpmpp_steps=(25, 25, 0), ddim_steps=(0, 0, 4), progress=False)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = serving_overrides(ultra_res(1, "v_param"), quant="int8", storage="float8_e4m3fn")
    cascade = Cascade(cfg, device="cuda")
    gen = torch.Generator(device=cascade.device).manual_seed(args.seed)
    params = [cascade.init_stage_params(n, gen) for n in range(1, cfg.num_stages + 1)]
    size = cfg.stages[-1].image_size
    zoomed = np.random.default_rng(args.seed).uniform(size=(size, size, 3)).astype(np.float32)
    n_patches = len(get_cond_images(zoomed, 1, overlap=LEVEL["overlap"], patch_size=size,
                                    materialize=False, device=cascade.device)[1])

    def level(wire, max_patches=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        canvas = generate_high_res_image(cascade, params, gen, zoomed, 1, wire=wire,
                                         max_patches=max_patches, **LEVEL)
        torch.cuda.synchronize()
        return time.perf_counter() - t, canvas

    for wire in WIRES:  # kernel builds and first launches, untimed
        level(wire, max_patches=4)
    walls = {w: [] for w in WIRES}
    for r in range(args.runs):
        for wire in (WIRES if r % 2 == 0 else WIRES[::-1]):
            wall, canvas = level(wire)
            walls[wire].append(wall)
            print(json.dumps(dict(run=r, wire=wire, wall_s=wall, patches=n_patches,
                                  patches_per_s=n_patches / wall, canvas=list(canvas.shape))),
                  flush=True)
    mean = {w: float(np.mean(v)) for w, v in walls.items()}
    print(json.dumps(dict(
        walls_s=walls, mean_s=mean,
        spread_s={w: max(v) - min(v) for w, v in walls.items()},
        resident_over_uint8=mean["resident"] / mean["uint8"],
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)), flush=True)


if __name__ == "__main__":
    main()

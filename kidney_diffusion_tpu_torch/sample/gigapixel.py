"""Gigapixel whole-slide generation: the batched-wavefront orchestrator.

Port of `kidney_diffusion_tpu/sample/gigapixel.py`. One magnification
refinement takes the stitched image of the level above (the coarse image)
and generates a grid of overlapping patches through the full cascade:

  * the dependency schedule is computed up front (`sample/wavefront.py`);
  * each wave of ready patches runs as batched `Cascade.sample_stage`
    calls, stage by stage, in chunks of at most the stage's batch cap, on
    one model per stage built when the stage starts (`Cascade.stage_model`)
    and dropped when it ends;
  * each patch is conditioned on a crop of the coarse image centred on it
    (`crop_with_fill`: out-of-bounds pixels take the fill value);
  * the overlap strips of already generated neighbours (above, next to it
    in the sweep direction, and the diagonal between them) are inpainted
    into the patch by the masked sampler (`assemble_inpaint_strips`), with
    a bilinear crop of the coarse image where a neighbour in the grid was
    not generated;
  * the stitch pastes the patches onto the bilinearly upscaled coarse image
    in uint8 (`stitch_patches`).

Transport (`wire`): "uint8" stages conditioning on the host and moves it as
uint8; None moves fp32; "resident" keeps the level on the device
(`sample/resident.py`). The three give the same guidance; "uint8" and
"resident" the same bits.

Random numbers: every `sample_stage` call draws from one `noise` source (a
`torch.Generator` on the cascade's device, or a callable `draw(shape)`),
in chunk order, stage by stage. Batches are padded to `bucket_size` by
repeating the last patch, so the draws of a chunk have the padded shape.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cascade import Cascade, stage_sampler_steps
from ..core.diffusion import NoiseSource
from ..data.wsi import MAG_LEVEL_SIZES, PATCH_SIZE, inner_patch_width, resize_nearest
from ..ops.image import foreground_mask_for_patches
from .wavefront import Pos, bucket_size, choose_orientation, full_grid, plan_waves

# ---------------------------------------------------------------------------
# host-side resize helpers
# ---------------------------------------------------------------------------


def bilinear_taps(out_size: int, in_size: int):
    """(i0, i1, w) of the half-pixel bilinear resize along one axis: output
    pixel i is input i0 * (1 - w) + input i1 * w (w fp32)."""
    pos = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, np.clip(pos - i0, 0.0, 1.0).astype(np.float32)


def nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """Input pixel of each output pixel of the nearest resize:
    floor((i + 0.5) * in / out)."""
    return np.clip(((np.arange(out_size) + 0.5) * in_size / out_size).astype(np.int64),
                   0, in_size - 1)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (HWC float), half-pixel centred like
    F.interpolate(align_corners=False), no antialiasing."""
    h, w = img.shape[:2]
    if h == out_h and w == out_w:
        return img
    y0, y1, wy = bilinear_taps(out_h, h)
    x0, x1, wx = bilinear_taps(out_w, w)
    wy, wx = wy[:, None, None], wx[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_nearest_batch(batch: np.ndarray, size: int) -> np.ndarray:
    """Nearest resize of (N, H, W, C) (`nearest_index`): the U-Net's own
    resize of conditioning images, so resizing before the upload gives the
    same bits."""
    h, w = batch.shape[1:3]
    if h == size and w == size:
        return batch
    return batch[:, nearest_index(size, h)][:, :, nearest_index(size, w)]


def to_wire_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8 [0, 255] (rounded). Conditioning images come
    from uint8 canvases, so this round trip is exact for them."""
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def crop_with_fill(
    img: np.ndarray, y0: int, x0: int, size: int, fill: float
) -> np.ndarray:
    """size² crop at (y0, x0) with out-of-bounds pixels set to `fill`: the
    reference's roll + edge fill + centre crop, which is a crop centred on
    a point."""
    h, w, c = img.shape
    out = np.full((size, size, c), fill, np.float32)
    ys, ye = max(y0, 0), min(y0 + size, h)
    xs, xe = max(x0, 0), min(x0 + size, w)
    if ys < ye and xs < xe:
        out[ys - y0 : ye - y0, xs - x0 : xe - x0] = img[ys:ye, xs:xe]
    return out


# ---------------------------------------------------------------------------
# conditioning-image construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Patch-grid geometry for one magnification level."""

    patch_width: int  # width of a mag-k patch inside the mag-(k-1) image
    patch_dist: int  # stride between patch origins in that image
    num_patches_width: int
    overlap: float

    @classmethod
    def build(
        cls,
        zoomed_width: int,
        mag_level: int,
        overlap: float,
        *,
        mag_sizes: Sequence[int] = MAG_LEVEL_SIZES,
        patch_size: int = PATCH_SIZE,
        airs: bool = False,
    ) -> "GridSpec":
        pw = inner_patch_width(mag_level, patch_size=patch_size, mag_sizes=tuple(mag_sizes))
        pd = int(pw * (1 - overlap))
        n = 1 + math.ceil((zoomed_width - pw) / pd)
        if airs:  # AIRS prefers staying in bounds
            n = max(1, n - 1)
        return cls(pw, pd, n, overlap)


def tissue_patch_filter(
    zoomed_image: np.ndarray, grid: GridSpec, *, airs: bool = False, device="cuda"
) -> List[Pos]:
    """mag-2 foreground filtering: only the patches whose window overlaps
    tissue. The mask is computed on `device`."""
    mask = foreground_mask_for_patches(zoomed_image, airs=airs, device=device).cpu().numpy()
    keep = []
    for i in range(grid.num_patches_width):
        for j in range(grid.num_patches_width):
            y, x = i * grid.patch_dist, j * grid.patch_dist
            window = mask[y : y + grid.patch_width, x : x + grid.patch_width]
            if window.size and window.any():
                keep.append((i, j))
    return keep


def get_cond_images(
    zoomed_image: np.ndarray,
    mag_level: int,
    *,
    overlap: float,
    mag_sizes: Sequence[int] = MAG_LEVEL_SIZES,
    patch_size: int = PATCH_SIZE,
    center_cond: bool = False,  # the "v2" 6-channel variant
    airs: bool = False,
    fill: float = 0.95,
    all_patches: bool = False,
    materialize: bool = True,
    device="cuda",
) -> Tuple[Optional[np.ndarray], List[Pos], GridSpec]:
    """Per-patch recentred conditioning images.

    zoomed_image: (H, W, 3) float [0, 1], the stitched mag-(k-1) output.
    Returns (cond_images (N, patch_size, patch_size, C), patch_pos, grid).

    `all_patches` skips the mag-2 tissue filter (which runs on `device`)
    and generates the full grid. `materialize=False` computes only
    (patch_pos, grid) and returns None cond images: the resident transport
    slices crops from the uploaded canvas instead."""
    if airs:
        fill = 0.0
    h, w = zoomed_image.shape[:2]
    grid = GridSpec.build(
        w, mag_level, overlap, mag_sizes=mag_sizes, patch_size=patch_size, airs=airs
    )

    if mag_level == 2 and not all_patches:
        patch_pos = tissue_patch_filter(zoomed_image, grid, airs=airs, device=device)
    else:
        patch_pos = full_grid(grid.num_patches_width)

    if not materialize:
        return None, patch_pos, grid

    conds = []
    for i, j in patch_pos:
        cy = i * grid.patch_dist + grid.patch_width // 2
        cx = j * grid.patch_dist + grid.patch_width // 2
        cond = crop_with_fill(
            zoomed_image, cy - patch_size // 2, cx - patch_size // 2, patch_size, fill
        )
        if center_cond:
            pw = grid.patch_width
            y0 = (patch_size - pw) // 2
            center = cond[y0 : y0 + pw, y0 : y0 + pw]
            # the centre channels are round-quantized, as the wire and the
            # resident canvas quantize them, so every transport agrees
            center_up = resize_nearest(
                to_wire_uint8(center), patch_size, patch_size
            ).astype(np.float32) / 255.0
            cond = np.concatenate([cond, center_up], axis=-1)
        conds.append(cond)
    return np.stack(conds) if conds else np.zeros((0, patch_size, patch_size, 3)), patch_pos, grid


# ---------------------------------------------------------------------------
# overlap-strip assembly (RePaint seam blending)
# ---------------------------------------------------------------------------


def assemble_inpaint_strips(
    wave: Sequence[Pos],
    generated: Dict[Pos, np.ndarray],
    cond_images_by_pos: Optional[Dict[Pos, np.ndarray]],
    grid: GridSpec,
    stage_size: int,
    orientation: int,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Build (inpaint_images, inpaint_masks) for a wave at one stage size.

    For each patch: if the above / next-to / diagonal neighbour was
    generated, its overlap strip is copied in; otherwise, if the coarse
    cond image covers that area, a bilinear-upscaled crop of it is used.
    mask=1 marks known pixels; the diagonal corner is written after the
    other strips and leaves the mask as they set it (the reference's
    behaviour)."""
    overlap_px = int(grid.overlap * stage_size)
    if overlap_px == 0:
        return None, None

    n = grid.num_patches_width
    imgs = np.zeros((len(wave), stage_size, stage_size, 3), np.float32)
    masks = np.zeros((len(wave), stage_size, stage_size), np.float32)
    any_strip = False

    def neighbor_patch(pos: Pos, base: Pos) -> Optional[np.ndarray]:
        """Neighbour pixels at stage_size² or None: a generated patch wins;
        otherwise (the neighbour is not in the patch set) the coarse cond
        image where it has image space in that direction."""
        if pos in generated:
            p = generated[pos]
            scale = 255.0 if p.dtype == np.uint8 else 1.0  # uint8-wire stores
            p = p.astype(np.float32) / scale
            if p.shape[0] != stage_size:
                p = resize_bilinear(p, stage_size, stage_size)
            return p
        if cond_images_by_pos is None:
            return None
        i, j = pos
        cond = cond_images_by_pos.get(base)
        if cond is None:
            return None
        ps = cond.shape[0]
        top_y = ps // 2 - grid.patch_width // 2 + (i - base[0]) * grid.patch_dist
        top_x = ps // 2 - grid.patch_width // 2 + (j - base[1]) * grid.patch_dist
        if top_y < 0 or top_x < 0 or top_y + grid.patch_width > ps or top_x + grid.patch_width > ps:
            return None
        crop = cond[top_y : top_y + grid.patch_width, top_x : top_x + grid.patch_width, :3]
        return resize_bilinear(crop, stage_size, stage_size)

    for b, (i, j) in enumerate(wave):
        above = neighbor_patch((i - 1, j), (i, j)) if i > 0 else None
        nj = j + orientation
        next_to = neighbor_patch((i, nj), (i, j)) if 0 <= nj < n else None
        diag = (
            neighbor_patch((i - 1, nj), (i, j)) if (i > 0 and 0 <= nj < n) else None
        )

        if above is not None:
            imgs[b, :overlap_px, :] = above[-overlap_px:, :]
            masks[b, :overlap_px, :] = 1.0
            any_strip = True
        if next_to is not None:
            if orientation == -1:
                imgs[b, :, :overlap_px] = next_to[:, -overlap_px:]
                masks[b, :, :overlap_px] = 1.0
            else:
                imgs[b, :, -overlap_px:] = next_to[:, :overlap_px]
                masks[b, :, -overlap_px:] = 1.0
            any_strip = True
        if diag is not None:
            if orientation == -1:
                imgs[b, :overlap_px, :overlap_px] = diag[-overlap_px:, -overlap_px:]
            else:
                imgs[b, :overlap_px, -overlap_px:] = diag[-overlap_px:, :overlap_px]
            any_strip = True

    if not any_strip:
        return None, None
    return imgs, masks


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------


def _stage_batch(
    stage_size: int,
    max_wave_batch: int,
    final_stage_batch: Optional[int],
    data_size: int,
    is_final: bool = True,
) -> int:
    """Wave-chunk batch cap for one stage: `max_wave_batch` at <= 256²;
    larger stages 1 patch per device unless `final_stage_batch` raises it
    on the final stage only."""
    if stage_size <= 256:
        return max_wave_batch
    return max((final_stage_batch if is_final else None) or 1, data_size, 1)


def _pad_to(arr: np.ndarray, b: int) -> np.ndarray:
    """Pad a batch to `b` by repeating its last element."""
    if arr.shape[0] == b:
        return arr
    reps = np.repeat(arr[-1:], b - arr.shape[0], axis=0)
    return np.concatenate([arr, reps], axis=0)


def _host(x) -> Optional[np.ndarray]:
    return None if x is None else x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def generate_patch_set(
    cascade: Cascade,
    params_per_stage: Sequence,
    noise: NoiseSource,
    *,
    patch_pos: List[Pos],
    grid: GridSpec,
    cond_images: Optional[np.ndarray],
    inpaint_resample_times: int = 1,
    ignore_stage_1: bool = False,
    max_wave_batch: int = 32,
    store_dtype=np.float16,
    progress: bool = True,
    mesh=None,
    debug_dir: Optional[str] = None,
    ddim_steps=0,
    dpmpp_steps=0,
    wire: Optional[str] = "uint8",
    zoomed_image: Optional[np.ndarray] = None,
    fill: float = 0.95,
    center_cond: bool = False,
    final_stage_batch: Optional[int] = None,
    metrics_hook=None,
) -> Dict[Pos, np.ndarray]:
    """Generate all patches of one magnification level through the full
    cascade, wave by wave, batched, on the cascade's device.

    `noise`: a `torch.Generator` on the cascade's device, or a callable
    `draw(shape)`; every stage call draws from it in chunk order.
    `final_stage_batch`: wave-batch cap for the > 256² final stage
    (default 1). `debug_dir`: dump every intermediate (cond image, inpaint
    strip and mask, per-stage patches) as PNGs. `metrics_hook(stage=,
    wave=, patches=, device_store_entries=)` is called after every wave.

    `wire="uint8"` (default) stages conditioning on the host and moves it
    as uint8: cond images pre-resized to the stage size (the U-Net's own
    nearest resize), strips and masks likewise; stage outputs come back
    uint8 and are stored uint8 between stages. `wire=None` moves fp32 and
    keeps `store_dtype` stores. `wire="resident"` keeps the level on the
    device (`sample/resident.py`): the coarse canvas (`zoomed_image`, with
    `fill` and `center_cond`) is uploaded once, or the `cond_images` stack
    when no canvas is given; all conditioning is assembled there, and only
    finished final-stage patches come back, copied in groups.

    Returns pos -> final-stage patch (stage_size², `store_dtype`; float
    stores in [0, 1], `np.uint8` the wire's [0, 255] values).
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharding wave batches over several cards is not ported yet "
            "(ROADMAP Queue 1 item 9, parallel)")
    resident = wire == "resident"
    num_stages = cascade.config.num_stages
    orientation = choose_orientation(patch_pos)
    waves = plan_waves(patch_pos, orientation)
    cond_by_pos = (
        {pos: cond_images[k] for k, pos in enumerate(patch_pos)}
        if cond_images is not None and not resident
        else None
    )

    engine = None
    if resident:
        from .resident import ResidentEngine, last_use_waves

        engine = ResidentEngine(
            patch_size=cascade.config.stages[-1].image_size,
            grid=grid,
            orientation=orientation,
            canvas=zoomed_image,
            cond_stack=cond_images if zoomed_image is None else None,
            patch_pos=patch_pos,
            fill=fill,
            center_cond=center_cond,
            store_dtype=store_dtype,
            device=cascade.device,
        )
        last_use = last_use_waves(waves, orientation)

    # per-stage generated patches (host arrays, or device tensors when resident)
    stores: List[Dict[Pos, object]] = [dict() for _ in range(num_stages + 1)]

    start_stage = 1
    if ignore_stage_1:
        # seed stage 2 with the centre crop of each cond image
        if resident:
            if engine.mode is None:
                raise ValueError("ignore_stage_1 needs conditioning")
            stores[1] = engine.seed_center_crops(patch_pos)
        else:
            if cond_by_pos is None:
                raise ValueError("ignore_stage_1 needs cond_images")
            ps = next(iter(cond_by_pos.values())).shape[0]
            y0 = ps // 2 - grid.patch_width // 2
            for pos, cond in cond_by_pos.items():
                crop = cond[
                    y0 : y0 + grid.patch_width, y0 : y0 + grid.patch_width, :3
                ]
                stores[1][pos] = (
                    to_wire_uint8(crop) if wire == "uint8" else crop.astype(store_dtype)
                )
        start_stage = 2

    if debug_dir is not None:
        from ..utils.logging import save_image

        os.makedirs(debug_dir, exist_ok=True)

    wire_u8 = wire == "uint8"
    for stage in range(start_stage, num_stages + 1):
        stage_size = cascade.config.stage(stage).image_size
        lowres_needed = cascade.config.stage(stage).lowres_cond
        stage_batch = _stage_batch(
            stage_size, max_wave_batch, final_stage_batch, 1,
            is_final=stage == num_stages,
        )
        # per-stage step counts (int or sequence); dpmpp wins per stage
        pstep = stage_sampler_steps(dpmpp_steps, stage, num_stages)
        dstep = stage_sampler_steps(ddim_steps, stage, num_stages)
        # one model for every chunk of the stage
        model = cascade.stage_model(params_per_stage[stage - 1], stage)
        for wi, wave in enumerate(waves):
            for chunk_start in range(0, len(wave), stage_batch):
                chunk = wave[chunk_start : chunk_start + stage_batch]
                bsz = bucket_size(len(chunk))
                inp = msk = None
                if resident:
                    kwargs = engine.prep_chunk(
                        chunk,
                        stage_size,
                        stores[stage],
                        stores[stage - 1] if lowres_needed else None,
                        bsz,
                        need_cond=engine.mode is not None,
                    )
                    if "inpaint_images" in kwargs:
                        kwargs["inpaint_resample_times"] = inpaint_resample_times
                else:
                    kwargs = {}
                    if cond_by_pos is not None:
                        conds = np.stack([cond_by_pos[p] for p in chunk]).astype(
                            np.float32
                        )
                        if wire_u8:
                            if conds.shape[1] > stage_size:
                                conds = resize_nearest_batch(conds, stage_size)
                            conds = to_wire_uint8(conds)
                        kwargs["cond_images"] = _pad_to(conds, bsz)
                    if lowres_needed:
                        lr = np.stack([stores[stage - 1][p] for p in chunk])
                        kwargs["lowres_image"] = _pad_to(
                            lr if wire_u8 else lr.astype(np.float32), bsz
                        )
                    inp, msk = assemble_inpaint_strips(
                        chunk, stores[stage], cond_by_pos, grid, stage_size, orientation
                    )
                    if inp is not None:
                        kwargs["inpaint_images"] = _pad_to(
                            to_wire_uint8(inp) if wire_u8 else inp, bsz
                        )
                        kwargs["inpaint_masks"] = _pad_to(
                            msk.astype(np.uint8) if wire_u8 else msk, bsz
                        )
                        kwargs["inpaint_resample_times"] = inpaint_resample_times

                if pstep > 0:
                    kwargs["dpmpp_steps"] = pstep
                elif dstep > 0:
                    kwargs["use_ddim"] = True
                    kwargs["ddim_steps"] = dstep
                if resident:
                    outs = cascade.sample_stage(
                        params_per_stage[stage - 1], stage, noise, batch_size=bsz,
                        output_dtype="uint8", output_split=True, model=model, **kwargs
                    )
                    for k, pos in enumerate(chunk):
                        stores[stage][pos] = outs[k]
                        if stage == num_stages:
                            engine.enqueue_final(pos, outs[k])
                else:
                    out = cascade.sample_stage(
                        params_per_stage[stage - 1], stage, noise, batch_size=bsz,
                        output_dtype="uint8" if wire_u8 else None, model=model,
                        **kwargs
                    )
                    out = out.cpu().numpy()[: len(chunk)]
                    # uint8-wire stores stay uint8 between stages (the
                    # resident store's values); fp32 wire keeps the
                    # compact-float store
                    if not wire_u8:
                        out = out.astype(store_dtype)
                    for k, pos in enumerate(chunk):
                        stores[stage][pos] = out[k]

                if debug_dir is not None:
                    if resident:
                        out = np.stack(
                            [_host(stores[stage][p]) for p in chunk]
                        ).astype(np.float32) / 255.0
                        ri, rm, rc = (_host(kwargs.get(k)) for k in (
                            "inpaint_images", "inpaint_masks", "cond_images"))
                        inp = None if ri is None else ri[: len(chunk)] / 255.0
                        msk = None if rm is None else rm[: len(chunk)].astype(np.float32)
                        cond_dump = None if rc is None else rc[: len(chunk)] / 255.0
                    else:
                        cond_dump = (
                            np.stack([cond_by_pos[p] for p in chunk])
                            if cond_by_pos is not None
                            else None
                        )
                    for k, pos in enumerate(chunk):
                        tag = f"s{stage}_w{wi}_{pos[0]}_{pos[1]}"
                        patch_f = out[k].astype(np.float32)
                        if out[k].dtype == np.uint8:
                            patch_f /= 255.0
                        save_image(patch_f, f"{debug_dir}/{tag}_patch.png")
                        if cond_dump is not None:
                            save_image(cond_dump[k][..., :3], f"{debug_dir}/{tag}_cond.png")
                        if inp is not None:
                            save_image(inp[k], f"{debug_dir}/{tag}_inpaint.png")
                            save_image(
                                np.repeat(msk[k][..., None], 3, -1),
                                f"{debug_dir}/{tag}_inpaint_mask.png",
                            )
            if resident and stage == num_stages:
                # final-stage device entries are dead once no later wave
                # reads their strips (the engine holds its own handle until
                # it has copied them): device memory stays bounded to a few
                # waves
                for pos in [
                    p for p in stores[stage] if last_use.get(p, -1) <= wi
                ]:
                    del stores[stage][pos]
            if metrics_hook is not None:
                metrics_hook(
                    stage=stage,
                    wave=wi,
                    patches=len(wave),
                    device_store_entries=sum(len(s) for s in stores),
                )
            if progress:
                done = sum(len(w) for w in waves[: wi + 1])
                print(
                    f"[gigapixel] stage {stage}: wave {wi + 1}/{len(waves)} "
                    f"({done}/{len(patch_pos)} patches)",
                    flush=True,
                )
        # stage s was the last reader of stores[s-1] (as lowres here, as
        # strips in stage s-1's own waves): free them now
        stores[stage - 1].clear()
        del model
    if resident:
        return engine.finish()
    if wire_u8 and store_dtype != np.uint8:
        # stores held uint8 between stages; the public contract is a
        # float store_dtype in [0, 1] (np.uint8 opts into the raw wire
        # values, as the stitch takes them)
        return {
            p: (v.astype(np.float32) / 255.0).astype(store_dtype)
            for p, v in stores[num_stages].items()
        }
    return stores[num_stages]


def stitch_patches(
    zoomed_image: np.ndarray,
    patches: Dict[Pos, np.ndarray],
    *,
    overlap: float,
    num_patches_width: int,
    patch_size: int = PATCH_SIZE,
) -> np.ndarray:
    """Paste generated patches onto the bilinearly upscaled coarse image.
    uint8 canvas, upscaled in row chunks."""
    patch_dist = int(patch_size * (1 - overlap))
    full = patch_size + (num_patches_width - 1) * patch_dist

    canvas = np.empty((full, full, 3), np.uint8)
    chunk_rows = max(1, 4096 * 4096 // max(full, 1))
    h = zoomed_image.shape[0]
    for y0 in range(0, full, chunk_rows):
        y1 = min(y0 + chunk_rows, full)
        ys = (np.arange(y0, y1) + 0.5) * h / full - 0.5
        lo = int(np.clip(np.floor(ys.min()), 0, h - 1))
        hi = int(np.clip(np.ceil(ys.max()) + 1, 1, h))
        # per-strip bilinear: resample source rows [lo, hi) to the output
        # strip using global coordinates
        src = zoomed_image[lo:hi].astype(np.float32)
        yy = ys - lo
        y0i = np.clip(np.floor(yy).astype(np.int64), 0, src.shape[0] - 1)
        y1i = np.minimum(y0i + 1, src.shape[0] - 1)
        wy = np.clip(yy - y0i, 0, 1).astype(np.float32)[:, None, None]
        w = zoomed_image.shape[1]
        xs = (np.arange(full) + 0.5) * w / full - 0.5
        x0i = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
        x1i = np.minimum(x0i + 1, w - 1)
        wx = np.clip(xs - x0i, 0, 1).astype(np.float32)[None, :, None]
        top = src[y0i][:, x0i] * (1 - wx) + src[y0i][:, x1i] * wx
        bot = src[y1i][:, x0i] * (1 - wx) + src[y1i][:, x1i] * wx
        canvas[y0:y1] = np.clip((top * (1 - wy) + bot * wy) * 255.0, 0, 255).astype(
            np.uint8
        )

    for (i, j), patch in patches.items():
        y, x = i * patch_dist, j * patch_dist
        patch = np.asarray(patch)
        if patch.dtype != np.uint8:
            patch = np.clip(patch.astype(np.float32) * 255.0, 0, 255).astype(
                np.uint8
            )
        canvas[y : y + patch_size, x : x + patch_size] = patch
    return canvas


def generate_high_res_image(
    cascade: Cascade,
    params_per_stage: Sequence,
    noise: NoiseSource,
    zoomed_image: np.ndarray,
    mag_level: int,
    *,
    overlap: float = 0.25,
    mag_sizes: Sequence[int] = MAG_LEVEL_SIZES,
    center_cond: bool = False,
    airs: bool = False,
    inpaint_resample_times: int = 1,
    ignore_stage_1: bool = False,
    max_wave_batch: int = 32,
    progress: bool = True,
    mesh=None,
    debug_dir: Optional[str] = None,
    max_patches: Optional[int] = None,
    ddim_steps=0,
    dpmpp_steps=0,
    all_patches: bool = False,
    wire: Optional[str] = "uint8",
    final_stage_batch: Optional[int] = None,
    metrics_hook=None,
) -> np.ndarray:
    """One magnification refinement on the cascade's device: coarse
    (H, W, 3) [0, 1] -> finer uint8 canvas. The model patch size is the
    cascade's final stage size (1024 for the ultra-res configs).

    `max_patches` truncates the patch set (the demo's 2x2 limit);
    `all_patches` disables the mag-2 tissue filter (see get_cond_images)."""
    patch_size = cascade.config.stages[-1].image_size
    resident = wire == "resident"
    cond_images, patch_pos, grid = get_cond_images(
        zoomed_image,
        mag_level,
        overlap=overlap,
        mag_sizes=mag_sizes,
        patch_size=patch_size,
        center_cond=center_cond,
        airs=airs,
        all_patches=all_patches,
        materialize=not resident,
        device=cascade.device,
    )
    if max_patches is not None and len(patch_pos) > max_patches:
        if cond_images is not None:
            cond_images = cond_images[:max_patches]
        patch_pos = patch_pos[:max_patches]
    if progress:
        print(
            f"[gigapixel] mag {mag_level}: {len(patch_pos)} patches, "
            f"grid {grid.num_patches_width}x{grid.num_patches_width}, "
            f"{len(plan_waves(patch_pos, choose_orientation(patch_pos)))} waves",
            flush=True,
        )
    patches = generate_patch_set(
        cascade,
        params_per_stage,
        noise,
        patch_pos=patch_pos,
        grid=grid,
        cond_images=cond_images,
        inpaint_resample_times=inpaint_resample_times,
        ignore_stage_1=ignore_stage_1,
        max_wave_batch=max_wave_batch,
        # the stitch quantizes to uint8 anyway: keep the wire's uint8 values
        store_dtype=np.uint8 if wire in ("uint8", "resident") else np.float16,
        progress=progress,
        mesh=mesh,
        debug_dir=debug_dir,
        ddim_steps=ddim_steps,
        dpmpp_steps=dpmpp_steps,
        wire=wire,
        zoomed_image=zoomed_image if resident else None,
        fill=0.0 if airs else 0.95,
        center_cond=center_cond,
        final_stage_batch=final_stage_batch,
        metrics_hook=metrics_hook,
    )
    return stitch_patches(
        zoomed_image,
        patches,
        overlap=overlap,
        num_patches_width=grid.num_patches_width,
        patch_size=patch_size,
    )

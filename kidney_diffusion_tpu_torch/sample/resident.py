"""Device-resident transport for the gigapixel orchestrator.

Port of `kidney_diffusion_tpu/sample/resident.py`. The uint8-wire path
stages every patch's conditioning on the host: the recentred cond crop and
the overlap strips go up, the finished patch comes down. This engine keeps
the whole level on the device instead:

  * the coarse canvas is encoded uint8 and uploaded once, padded with the
    fill value so every recentred crop lies inside it (the same pixels as
    `gigapixel.crop_with_fill`); callers without a canvas upload their
    materialized cond stack instead;
  * per wave chunk, `prep_chunk` assembles the chunk's conditioning on the
    device by tensor indexing: cond crops gathered at the stage size (the
    U-Net's own nearest resize, composed with the crop), the low-res input
    from the previous stage's store, and the overlap strips and masks from
    neighbour patches, with the coarse-image fallback (bilinear as
    `gigapixel.resize_bilinear`) and the diagonal-corner behaviour of
    `gigapixel.assemble_inpaint_strips`;
  * stage outputs stay on the device (uint8), one handle per patch
    (`Cascade.sample_stage(output_split=True)`);
  * only final-stage patches come back, copied to the host in groups of
    FETCH_BATCH as they finish (and the rest in `finish()`). The engine
    holds a pending patch until its group is copied, so the orchestrator's
    last-use eviction drops only the store's reference.

The JAX package copies final patches on a background thread to hide the
host link. On the card such a copy is about a millisecond for a group of
eight patches that took seconds to sample, so the port copies
synchronously.

The JAX package fuses the prep into the sampling program and scans a
chunk's batch-1 patches inside one program; both cut dispatches over the
TPU host link. In eager PyTorch both are the same calls as the unfused,
batch-1 path, so the port has that one path.

Numerics match the uint8 wire: every transported image is quantized to
1/255 at the same points, so `wire="resident"` and `wire="uint8"` give the
same bits, except at coarse-fallback strip pixels whose crop reaches into
the fill region (the canvas holds the fill rounded to uint8): within one
count there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .gigapixel import bilinear_taps, nearest_index
from .wavefront import Pos, deps

# final patches per copy to the host: the device holds at most this many
# finished patches that no later wave reads
FETCH_BATCH = 8


def last_use_waves(waves: Sequence[Sequence[Pos]], orientation: int) -> Dict[Pos, int]:
    """pos -> index of the last wave whose patches read pos as a strip
    neighbour. Eviction after that wave is exact even for irregular
    (tissue-filtered) patch sets where a dependency can finish many waves
    before its consumer runs."""
    last: Dict[Pos, int] = {}
    for wi, wave in enumerate(waves):
        for pos in wave:
            for d in deps(pos, orientation):
                last[d] = max(last.get(d, -1), wi)
    return last


class ResidentEngine:
    """Per-level device-resident state: the padded uint8 canvas (or cond
    stack) on the device, and the final patches on their way to the host
    (`enqueue_final`, then `finish()`)."""

    def __init__(
        self,
        *,
        patch_size: int,
        grid,
        orientation: int,
        canvas: Optional[np.ndarray] = None,
        cond_stack: Optional[np.ndarray] = None,
        patch_pos: Optional[Sequence[Pos]] = None,
        fill: float = 0.95,
        center_cond: bool = False,
        store_dtype=np.float16,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.ps = patch_size
        self.grid = grid
        self.orientation = orientation
        self.center_cond = center_cond
        self.store_dtype = store_dtype
        self.mode: Optional[str] = None
        self.P: Optional[torch.Tensor] = None  # canvas mode: padded uint8 canvas
        self.stack: Optional[torch.Tensor] = None  # stack mode: uint8 cond stack
        self._pos_index: Dict[Pos, int] = {}

        if canvas is not None:
            pad_lo = patch_size // 2
            # the last grid row / column can overhang the canvas by up to one
            # stride: pad the high side a full patch so every crop (cond and
            # coarse-strip fallback) stays inside
            pad_hi = patch_size
            c8 = np.clip(np.round(canvas[..., :3] * 255.0), 0, 255).astype(np.uint8)
            fill8 = int(np.clip(round(fill * 255.0), 0, 255))
            h, w = c8.shape[:2]
            self.P = torch.full((h + pad_lo + pad_hi, w + pad_lo + pad_hi, 3), fill8,
                                dtype=torch.uint8, device=self.device)
            self.P[pad_lo : pad_lo + h, pad_lo : pad_lo + w] = torch.from_numpy(c8).to(
                self.device)
            self.mode = "canvas"
        elif cond_stack is not None:
            s = cond_stack
            if s.dtype != np.uint8:
                s = np.clip(np.round(s.astype(np.float32) * 255.0), 0, 255).astype(np.uint8)
            self.stack = torch.from_numpy(np.ascontiguousarray(s)).to(self.device)
            self._pos_index = {pos: k for k, pos in enumerate(patch_pos or [])}
            self.mode = "stack"

        self._zeros_cache: Dict[int, torch.Tensor] = {}
        # uint8 -> [0, 1] as the host divides (on the card a tensor divided by
        # a scalar is multiplied by its reciprocal, which can round otherwise)
        self._lut = torch.from_numpy(np.arange(256, dtype=np.float32) / np.float32(255.0)
                                     ).to(self.device)

        self.final_host: Dict[Pos, np.ndarray] = {}
        self._final_pending: List[Tuple[Pos, torch.Tensor]] = []

    # ------------------------------------------------------------------
    # finished patches -> host
    # ------------------------------------------------------------------

    def enqueue_final(self, pos: Pos, arr: torch.Tensor) -> None:
        """Take a finished final-stage patch (a device uint8 tensor); the
        patches go to the host in groups of FETCH_BATCH."""
        self._final_pending.append((pos, arr))
        if len(self._final_pending) >= FETCH_BATCH:
            self._copy_finals()

    def _copy_finals(self) -> None:
        pending, self._final_pending = self._final_pending, []
        if not pending:
            return
        rows = torch.stack([a for _, a in pending]).cpu().numpy()
        if self.store_dtype != np.uint8:
            rows = (rows.astype(np.float32) / 255.0).astype(self.store_dtype)
        for (p, _), row in zip(pending, rows):
            self.final_host[p] = row

    def finish(self) -> Dict[Pos, np.ndarray]:
        """Copy the last final patches and return them all, on the host."""
        self._copy_finals()
        return self.final_host

    # ------------------------------------------------------------------
    # device-side helpers
    # ------------------------------------------------------------------

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _zeros(self, size: int) -> torch.Tensor:
        if size not in self._zeros_cache:
            self._zeros_cache[size] = torch.zeros((size, size, 3), dtype=torch.uint8,
                                                  device=self.device)
        return self._zeros_cache[size]

    def center(self, pos: Pos) -> Tuple[int, int]:
        i, j = pos
        return (
            i * self.grid.patch_dist + self.grid.patch_width // 2,
            j * self.grid.patch_dist + self.grid.patch_width // 2,
        )

    def _gather(self, idx, rows, cols, channels=slice(0, 3)) -> torch.Tensor:
        """src[b, rows[b], cols[b], channels] for a batch: rows, cols are
        (B, H) and (B, W) int arrays, or (H,) and (W,) shared by the batch;
        idx (B,) picks the stack image (stack mode), unused on the canvas."""
        r, c = self._idx(rows), self._idx(cols)
        r, c = (r[None] if r.ndim == 1 else r)[:, :, None], (c[None] if c.ndim == 1 else c)[:, None]
        if self.mode == "canvas":
            return self.P[r, c][..., channels]
        return self.stack[self._idx(idx)[:, None, None], r, c][..., channels]

    def seed_center_crops(self, patch_pos: Sequence[Pos]) -> Dict[Pos, torch.Tensor]:
        """`ignore_stage_1` seeding: the patch_width² centre crop of every
        cond image, a device uint8 tensor per pos."""
        pw = self.grid.patch_width
        span = np.arange(pw)
        off = self.ps // 2 - pw // 2  # the centre crop's start inside a cond image
        if self.mode == "canvas":
            # cond[u, v] = P[cy + u, cx + v]
            starts = np.asarray([self.center(p) for p in patch_pos]) + off
            idx = np.zeros(len(patch_pos), np.int64)
        elif self.mode == "stack":
            starts = np.full((len(patch_pos), 2), off)
            idx = [self._pos_index[p] for p in patch_pos]
        else:
            raise ValueError("ignore_stage_1 needs conditioning")
        crops = self._gather(idx, starts[:, :1] + span, starts[:, 1:] + span)
        return dict(zip(patch_pos, crops.unbind(0)))

    # ------------------------------------------------------------------
    # per-chunk conditioning assembly
    # ------------------------------------------------------------------

    def _coarse(self, idx, tops, hs: int) -> torch.Tensor:
        """Coarse-fallback strips: the patch_width² crop of each cond image at
        `tops` (K, 2), resized bilinearly to hs² as `resize_bilinear` does in
        fp32 on [0, 1] values, rounded to uint8."""
        pw = self.grid.patch_width
        span = np.arange(pw)
        img = self._lut[self._gather(idx, tops[:, :1] + span, tops[:, 1:] + span).long()]
        i0, i1, w = bilinear_taps(hs, pw)
        i0, i1 = self._idx(i0), self._idx(i1)
        w = torch.from_numpy(w).to(self.device)
        wy, wx = w[None, :, None, None], w[None, None, :, None]
        top = img[:, i0][:, :, i0] * (1 - wx) + img[:, i0][:, :, i1] * wx
        bot = img[:, i1][:, :, i0] * (1 - wx) + img[:, i1][:, :, i1] * wx
        out = top * (1 - wy) + bot * wy
        return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)

    def prep_chunk(
        self,
        chunk: Sequence[Pos],
        stage_size: int,
        stores_stage: Dict[Pos, torch.Tensor],
        lowres_store: Optional[Dict[Pos, torch.Tensor]],
        bsz: int,
        *,
        need_cond: bool,
    ) -> dict:
        """`Cascade.sample_stage` keyword arguments (device uint8 tensors,
        batch padded to `bsz` by repeating the last patch) for one wave
        chunk at one stage: "cond_images" at the stage size, "lowres_image",
        and "inpaint_images" / "inpaint_masks" when any strip is known."""
        g = self.grid
        hs = stage_size
        ov = int(g.overlap * hs)
        n = g.num_patches_width
        ori = self.orientation
        pad = [len(chunk) - 1] * (bsz - len(chunk))
        order = list(range(len(chunk))) + pad
        kwargs = {}

        centers = np.asarray([self.center(p) for p in chunk], np.int64)[order]
        idx = (np.asarray([self._pos_index[p] for p in chunk], np.int64)[order]
               if self.mode == "stack" else np.zeros(bsz, np.int64))
        if need_cond and self.mode is not None:
            # cond[u, v] = P[cy + u, cx + v] (canvas) or stack[k, u, v]; read at
            # the U-Net's nearest-resize positions of the stage size
            yi = nearest_index(hs, self.ps)
            if self.mode == "canvas":
                conds = self._gather(idx, centers[:, :1] + yi, centers[:, 1:] + yi)
                if self.center_cond:
                    # the centre channels: the pw² centre crop of the
                    # round-quantized canvas upsampled (nearest) to ps², as
                    # get_cond_images makes them
                    pw = g.patch_width
                    ci = (self.ps - pw) // 2 + nearest_index(self.ps, pw)[yi]
                    conds = torch.cat([conds, self._gather(idx, centers[:, :1] + ci,
                                                           centers[:, 1:] + ci)], dim=-1)
            else:  # the stack was materialized with any centre channels appended
                conds = self._gather(idx, yi, yi, slice(None))
            kwargs["cond_images"] = conds
        if lowres_store is not None:
            kwargs["lowres_image"] = torch.stack([lowres_store[chunk[k]] for k in order])

        if ov <= 0:
            return kwargs
        zero = self._zeros(hs)
        fallback_ok = self.mode is not None and need_cond
        kinds = np.zeros((len(chunk), 3), np.int64)
        slots: List[List[torch.Tensor]] = [[], [], []]
        coarse = []  # (slot, b, stack index, top_y, top_x) of fallback strips
        for b, (i, j) in enumerate(chunk):
            cy, cx = centers[b]
            nj = j + ori
            neighbors = ((i - 1, j), (i, nj), (i - 1, nj))
            valid = (i > 0, 0 <= nj < n, i > 0 and 0 <= nj < n)
            for s in range(3):
                npos, ok = neighbors[s], valid[s]
                arr = zero
                if ok and npos in stores_stage:
                    kinds[b, s] = 1
                    arr = stores_stage[npos]
                elif ok and fallback_ok:
                    ni, nj2 = npos
                    top_y = self.ps // 2 - g.patch_width // 2 + (ni - i) * g.patch_dist
                    top_x = self.ps // 2 - g.patch_width // 2 + (nj2 - j) * g.patch_dist
                    if (0 <= top_y and 0 <= top_x and top_y + g.patch_width <= self.ps
                            and top_x + g.patch_width <= self.ps):
                        kinds[b, s] = 2
                        if self.mode == "canvas":  # cond[u, v] = P[cy + u, cx + v]
                            top_y, top_x = cy + top_y, cx + top_x
                        coarse.append((s, b, idx[b], top_y, top_x))
                slots[s].append(arr)
        if not kinds.any():
            return kwargs

        stacked = [torch.stack(s) for s in slots]
        if coarse:
            c = np.asarray(coarse, np.int64)
            strips = self._coarse(c[:, 2], c[:, 3:5], hs)
            for k, (s, b) in enumerate(c[:, :2].tolist()):
                stacked[s][b] = strips[k]
        order_t = self._idx(order)
        above, nxt, dia = (t[order_t] for t in stacked)  # padded to bsz
        has = torch.from_numpy(kinds[order] > 0).to(self.device)
        imgs = torch.zeros((bsz, hs, hs, 3), dtype=torch.uint8, device=self.device)
        masks = torch.zeros((bsz, hs, hs), dtype=torch.uint8, device=self.device)
        one = torch.ones((), dtype=torch.uint8, device=self.device)
        ha4, hn4, hd4 = (has[:, s, None, None, None] for s in range(3))
        ha3, hn3 = has[:, 0, None, None], has[:, 1, None, None]
        imgs[:, :ov] = torch.where(ha4, above[:, -ov:], imgs[:, :ov])
        masks[:, :ov] = torch.where(ha3, one, masks[:, :ov])
        if ori == -1:
            imgs[:, :, :ov] = torch.where(hn4, nxt[:, :, -ov:], imgs[:, :, :ov])
            masks[:, :, :ov] = torch.where(hn3, one, masks[:, :, :ov])
            # the diagonal corner last (it wins), the mask untouched
            imgs[:, :ov, :ov] = torch.where(hd4, dia[:, -ov:, -ov:], imgs[:, :ov, :ov])
        else:
            imgs[:, :, -ov:] = torch.where(hn4, nxt[:, :, :ov], imgs[:, :, -ov:])
            masks[:, :, -ov:] = torch.where(hn3, one, masks[:, :, -ov:])
            imgs[:, :ov, -ov:] = torch.where(hd4, dia[:, -ov:, :ov], imgs[:, :ov, -ov:])
        kwargs["inpaint_images"] = imgs
        kwargs["inpaint_masks"] = masks
        return kwargs

"""Gigapixel sampling of the port: the wavefront plan (`wavefront.py`), the
orchestrator (`gigapixel.py`) and its device-resident transport
(`resident.py`). Outpainting is not ported yet."""

from .gigapixel import (
    GridSpec,
    assemble_inpaint_strips,
    crop_with_fill,
    generate_high_res_image,
    generate_patch_set,
    get_cond_images,
    resize_bilinear,
    stitch_patches,
    tissue_patch_filter,
)
from .wavefront import (
    bucket_size,
    choose_orientation,
    deps,
    full_grid,
    plan_waves,
    ready_patches,
)

__all__ = [
    "GridSpec",
    "assemble_inpaint_strips",
    "bucket_size",
    "choose_orientation",
    "crop_with_fill",
    "deps",
    "full_grid",
    "generate_high_res_image",
    "generate_patch_set",
    "get_cond_images",
    "plan_waves",
    "ready_patches",
    "resize_bilinear",
    "stitch_patches",
    "tissue_patch_filter",
]

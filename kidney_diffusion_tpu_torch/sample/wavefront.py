"""Wavefront scheduling for the gigapixel patch grid (pure functions).

A copy of `kidney_diffusion_tpu/sample/wavefront.py` (the port imports
nothing of the JAX package). A patch waits for its neighbours above,
next to it in the chosen orientation, and the diagonal between them. That
order is a static property of the patch set, so the whole schedule is
computed up front as a list of *waves*: every patch in wave k depends only
on patches in waves < k, so each wave is generated as batched denoise
calls. Wave sizes are padded to a small set of buckets.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

Pos = Tuple[int, int]


def deps(pos: Pos, orientation: int) -> Tuple[Pos, Pos, Pos]:
    """The three neighbours a patch waits for."""
    i, j = pos
    return (i - 1, j), (i, j + orientation), (i - 1, j + orientation)


def ready_patches(
    remaining: Sequence[Pos], orientation: int
) -> Tuple[List[Pos], List[Pos]]:
    """Split `remaining` into (ready, waiting): a patch is ready when none
    of its dependencies are still in `remaining`."""
    remaining_set = set(remaining)
    ready, waiting = [], []
    for pos in remaining:
        if any(d in remaining_set for d in deps(pos, orientation)):
            waiting.append(pos)
        else:
            ready.append(pos)
    return ready, waiting


def choose_orientation(patch_pos: Sequence[Pos]) -> int:
    """Pick the sweep direction whose first wave is larger."""
    left = len(ready_patches(patch_pos, -1)[0])
    right = len(ready_patches(patch_pos, 1)[0])
    return -1 if left > right else 1


def plan_waves(patch_pos: Sequence[Pos], orientation: int) -> List[List[Pos]]:
    """Static wavefront schedule: list of waves, each a list of positions.

    Invariant (property-tested): every patch's dependencies lie in
    strictly earlier waves; the union of all waves is `patch_pos`.
    """
    remaining = list(patch_pos)
    waves: List[List[Pos]] = []
    while remaining:
        ready, remaining = ready_patches(remaining, orientation)
        if not ready:
            raise RuntimeError(
                f"wavefront deadlock with {len(remaining)} patches; "
                "dependency graph must be acyclic for grid patches"
            )
        waves.append(ready)
    return waves


def bucket_size(n: int, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128)) -> int:
    """Smallest bucket >= n: the batch a wave chunk is padded to."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


def full_grid(num_patches_width: int) -> List[Pos]:
    """All positions of an N×N grid (outpainting, coarse mag levels)."""
    return [(i, j) for i in range(num_patches_width) for j in range(num_patches_width)]

"""Checkpoint files of the port: nested dicts of tensors with metadata.

Port of `kidney_diffusion_tpu/utils/checkpoint.py:68-140` for local paths.
A checkpoint is a directory holding `state.pt` (the tree, written with
`torch.save`) and `kdt_meta.json` (`{"version": <the port's __version__>,
**metadata}`); loading a checkpoint written by another version warns.

- The overwrite is crash-safe: the new checkpoint is written in full to a
  `<name>.tmp_save` sibling, then the old one is deleted and the new one
  renamed into its place, so a save that dies leaves the old one loadable.
- `load_checkpoint(..., partial=True)` restores every leaf the file holds
  at the target's shape and keeps the target's current value of any other.

The JAX package's checkpoints are Orbax directories; reading one needs JAX,
which the port does not import.
"""

from __future__ import annotations

import json
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .. import __version__

META_NAME = "kdt_meta.json"
STATE_NAME = "state.pt"


def _path(path) -> Path:
    return Path(path).expanduser().absolute()


def save_checkpoint(path, tree: Dict, *, metadata: Optional[dict] = None) -> None:
    """Write `tree` (nested dicts of tensors) and its metadata to the
    directory `path`, replacing what is there only once the new checkpoint
    is complete."""
    p = _path(path)
    tmp = p.parent / (p.name + ".tmp_save")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(tree, tmp / STATE_NAME)
    (tmp / META_NAME).write_text(json.dumps({"version": __version__, **(metadata or {})}))
    if p.exists():
        shutil.rmtree(p)
    tmp.rename(p)


def checkpoint_exists(path) -> bool:
    return _path(path).is_dir()


def load_metadata(path) -> dict:
    meta = _path(path) / META_NAME
    return json.loads(meta.read_text()) if meta.exists() else {}


def flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b/c": leaf}."""
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(flatten(val, name))
        else:
            flat[name] = val
    return flat


def unflatten_like(target: Dict, flat: Dict[str, Any], prefix: str = "") -> Dict:
    out = {}
    for key, val in target.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        out[key] = unflatten_like(val, flat, name) if isinstance(val, dict) else flat[name]
    return out


def load_checkpoint(path, target: Optional[Dict] = None, *, partial: bool = False,
                    map_location=None) -> Dict:
    """The tree saved at `path`. With a `target` tree (tensors, or meta
    tensors that give only shapes and dtypes) the result has its structure,
    each leaf in the target's dtype on `map_location`: all of them from the
    file, which must hold each at its shape, or with `partial=True` those
    the file holds at the target's shape, the target's values elsewhere."""
    p = _path(path)
    meta = load_metadata(p)
    if meta.get("version") and meta["version"] != __version__:
        warnings.warn(f"checkpoint {p} was saved at version {meta['version']}, "
                      f"this is {__version__}")
    raw = torch.load(p / STATE_NAME, map_location=map_location, weights_only=True)
    if target is None:
        return raw
    flat_raw, flat_target = flatten(raw), flatten(target)
    merged, skipped = {}, []
    for key, want in flat_target.items():
        got = flat_raw.get(key)
        if got is not None and tuple(got.shape) == tuple(want.shape):
            dev = got.device if want.device.type == "meta" else want.device
            merged[key] = got.to(device=dev, dtype=want.dtype)
        else:
            skipped.append(key)
            merged[key] = want
    if skipped and not partial:
        raise ValueError(f"checkpoint {p} does not hold {len(skipped)} leaves of the target "
                         f"at their shapes (e.g. {skipped[:3]}); use partial=True")
    if skipped:
        warnings.warn(f"partial restore of {p} kept the current value of {len(skipped)} "
                      f"leaves: {skipped[:5]}{'...' if len(skipped) > 5 else ''}")
    return unflatten_like(target, merged)

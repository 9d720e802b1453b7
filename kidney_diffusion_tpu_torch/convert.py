"""Parameters of the port: carried over from a Flax tree, or made anew.

The port's modules keep the Flax parameter names and layouts (conv kernels
HWIO, dense kernels (in, out)), so a Flax path such as
`params/down0_block0/block1/conv/kernel` is the `state_dict()` key
`down0_block0.block1.conv.kernel` and the array is copied unchanged.

`init_stage_params` builds the same names and shapes directly on a device
with Flax's initializers (truncated lecun-normal kernels, zero biases, unit
norm scales, a zero final conv, N(0, 0.02) null text tokens), so the card
never needs JAX to get weights.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .device import resolve_device
from .models.configs import CascadeConfig
from .models.unet import EfficientUNet

Params = Dict[str, torch.Tensor]


def flatten_flax(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts (a Flax variables tree, numpy leaves) -> {dotted: array}.
    A top-level `params` collection is dropped."""
    if prefix == "" and set(tree) == {"params"}:
        tree = tree["params"]
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_flax(val, name))
        else:
            flat[name] = np.asarray(val)
    return flat


def from_flax(tree: Mapping, device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Flax parameter tree (numpy leaves) -> the port's parameter dict."""
    dev = resolve_device(device)
    out = {}
    for name, arr in flatten_flax(tree).items():
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        out[name] = t.to(dtype) if dtype is not None else t
    return out


def build_model(config, params: Optional[Params] = None, device="meta") -> EfficientUNet:
    """An `EfficientUNet` for a `UNetConfig`; with `params`, those tensors
    become its parameters (no copy), strictly by name and shape."""
    with torch.device(device):
        model = EfficientUNet(config)
    if params is not None:
        model.load_state_dict(params, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def init_stage_params(config: CascadeConfig, unet_number: int,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> Params:
    """Fresh fp32 parameters of one stage, made on `device` from `generator`
    with the Flax initializers. `device="meta"` gives names and shapes only."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    model = build_model(config.stage(unet_number).unet, device=dev)
    if dev.type != "meta":
        for mod in model.modules():
            if hasattr(mod, "init_params"):
                mod.init_params(generator)
    return {name: p.detach() for name, p in model.named_parameters()}

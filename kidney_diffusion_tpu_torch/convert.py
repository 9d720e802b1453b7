"""Parameters of the port: carried over from a Flax tree, or made anew.

The port's modules keep the Flax parameter names and layouts (conv kernels
HWIO, dense kernels (in, out)), so a Flax path such as
`params/down0_block0/block1/conv/kernel` is the `state_dict()` key
`down0_block0.block1.conv.kernel` and the array is copied unchanged.

`init_stage_params` builds the same names and shapes directly on a device
with Flax's initializers (truncated lecun-normal kernels, zero biases, unit
norm scales, a zero final conv, N(0, 0.02) null text tokens), so the card
never needs JAX to get weights.

`from_flax_state` carries a whole training state of the JAX trainer
(parameters, EMA, optax's Adam moments and count, step) into the port's
`train.trainer.StageState`, so both trainers can start from one state.
Reading an Orbax checkpoint needs JAX; a converter from one is not here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

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
        t = torch.from_numpy(np.array(arr, copy=True)).to(dev)  # never aliases the caller's array
        out[name] = t.to(dtype) if dtype is not None else t
    return out


def _adam_state(opt_state):
    """optax's `ScaleByAdamState` (fields count, mu, nu) inside a chain's
    state, e.g. `(EmptyState(), (ScaleByAdamState(...), EmptyState()))` for
    clip_by_global_norm then adam."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def from_flax_state(state, device="cuda"):
    """A JAX trainer's `StageState` with numpy leaves (`jax.device_get`) ->
    the port's `train.trainer.StageState`: params as fp32 `nn.Parameter`s,
    the EMA, the Adam count and moments, the step."""
    from .train.optim import AdamState
    from .train.trainer import StageState

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    dev = resolve_device(device)
    return StageState(
        params={k: nn.Parameter(v) for k, v in from_flax(state.params, dev).items()},
        ema_params=from_flax(state.ema_params, dev),
        opt_state=AdamState(torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
                            from_flax(adam.mu, dev), from_flax(adam.nu, dev)),
        step=int(np.asarray(state.step)))


def build_model(config, params: Optional[Params] = None, device="meta", *,
                trainable: bool = False) -> EfficientUNet:
    """An `EfficientUNet` for a `UNetConfig`; with `params`, those tensors
    become its parameters (no copy), strictly by name and shape.

    By default the model is frozen (no parameter requires grad) and the
    caller's tensors keep their own flags. With `trainable=True` the
    parameters are the caller's `nn.Parameter` objects themselves, so
    gradients of the model's outputs reach them (a `Trainer`'s state)."""
    with torch.device(device):
        model = EfficientUNet(config)
    if params is not None:
        if trainable:
            plain = [k for k, v in params.items() if not isinstance(v, nn.Parameter)]
            if plain:
                raise TypeError(f"trainable parameters must be nn.Parameter, not {plain[:3]}")
        else:
            params = {k: v.detach() for k, v in params.items()}
        model.load_state_dict(params, strict=True, assign=True)
    if trainable:
        return model.train().requires_grad_(True)
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

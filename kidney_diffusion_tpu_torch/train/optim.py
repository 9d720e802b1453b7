"""The optimizer and EMA arithmetic of the `Trainer`, written out.

`clip_by_global_norm` then `adam_update` are one update of
`optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, b1, b2,
eps))`, the chain of `kidney_diffusion_tpu/train/trainer.py:101-108`, step
for step in fp32:

- clipping by the global norm ||g|| = sqrt(sum of every squared entry):
  unchanged where ||g|| < max_norm, else (g / ||g||) * max_norm, with no
  epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm);
- Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count + 1, then
  p + (-lr) * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).

`ema_update` is the trainer's EMA, e * d + p * (1 - d), with the warmup
decay d = min(max_decay, (1 + step) / (10 + step)) in fp32 (`ema_decay`).

The functions work in place on lists of tensors with PyTorch's `_foreach`
operations (a few launches per update, whatever the number of tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class AdamState:
    """optax's `ScaleByAdamState`: the update count (an int32 scalar on the
    host) and the first and second moments, fp32, keyed like the params."""

    count: Tensor
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]

    @classmethod
    def zeros_like(cls, params: Dict[str, Tensor]) -> "AdamState":
        zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32)  # noqa: E731
                         for k, v in params.items()}
        return cls(torch.zeros((), dtype=torch.int32), zeros(), zeros())


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt of the sum of every squared entry (fp32 scalar on their device)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float) -> Tuple[List[Tensor], Tensor]:
    """(clipped grads, global norm) by optax's rule: the grads unchanged when
    their global norm is below `max_norm`, else (g / norm) * max_norm."""
    norm = global_norm(grads)
    value = norm.item()
    if value < max_norm:
        return list(grads), norm
    clipped = torch._foreach_div(list(grads), value)  # a NaN norm gives NaNs, as in optax
    torch._foreach_mul_(clipped, max_norm)
    return clipped, norm


def adam_update(params: Dict[str, Tensor], grads: Sequence[Tensor], state: AdamState,
                lr: float, b1: float, b2: float, eps: float) -> None:
    """One `optax.adam` step, applied in place to `params` and `state`;
    `grads` in the order of `params`."""
    mu, nu = [state.mu[k] for k in params], [state.nu[k] for k in params]
    params, grads = list(params.values()), list(grads)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1.0 - b2)
    torch._foreach_add_(nu, sq)
    del sq
    count = int(state.count) + 1
    state.count = torch.tensor(count, dtype=torch.int32)
    one = np.float32(1.0)
    bc1 = float(one - np.float32(b1) ** np.float32(count))
    bc2 = float(one - np.float32(b2) ** np.float32(count))
    step = torch._foreach_div(mu, bc1)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(step, denom)
    del denom
    torch._foreach_mul_(step, -lr)
    torch._foreach_add_(params, step)


def ema_decay(max_decay: float, step: int) -> float:
    """min(max_decay, (1 + step) / (10 + step)), rounded as fp32."""
    warm = np.float32(1.0 + step) / np.float32(10.0 + step)
    return float(min(np.float32(max_decay), warm))


def ema_update(ema: Dict[str, Tensor], params: Dict[str, Tensor], decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), in place, in fp32."""
    targets = [ema[k] for k in params]
    scaled = torch._foreach_mul([p.detach() for p in params.values()],
                                float(np.float32(1.0) - np.float32(decay)))
    torch._foreach_mul_(targets, decay)
    torch._foreach_add_(targets, scaled)

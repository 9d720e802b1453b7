"""Trainer — per-stage Adam, gradient clipping, EMA and checkpoints.

Port of `kidney_diffusion_tpu/train/trainer.py` on one device: `state` with
the `only_train_unet_number` guard, `train_step` (gradient accumulation over
`grad_accum_chunks` slices of the batch, then global-norm clipping, Adam
and the EMA with its warmup, as `_build_step_fn` does), `valid_step`,
`num_steps_taken`, `drop_state`, `sample` with the EMA weights, and `save` /
`load` (`ema_only` serving checkpoints, `partial` restores, the error when a
restore fails after the live state was dropped).

A stage's parameters are fp32 `nn.Parameter`s; the U-Net computes in its
config's dtype (bf16 for the flagship) through the kernels of
`kidney_diffusion_tpu_torch.kernels`, and the gradients come back in fp32.
The EMA and the optimizer state are fp32. Random draws (initial weights and
`stage_loss`'s times, noise, crops and augmentation) come from one
`torch.Generator` seeded with `seed` on the cascade's device.

Not ported yet: the mesh and FSDP (`mesh=`, `fsdp=`), and dataset
attachment (`add_train_dataset`, `add_valid_dataset`): `train_step` and
`valid_step` take their batch from the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..cascade import Cascade
from ..convert import Params, init_stage_params
from ..utils.checkpoint import checkpoint_exists, load_checkpoint, load_metadata, save_checkpoint
from .optim import AdamState, adam_update, clip_by_global_norm, ema_decay, ema_update, global_norm

Tensor = torch.Tensor
Draws = Mapping[str, Tensor]


@dataclasses.dataclass
class StageState:
    """All mutable training state of one stage (`StageState` of the JAX
    trainer): fp32 parameters (`nn.Parameter`s), their EMA, optax's Adam
    state and the number of steps taken."""

    params: Params
    ema_params: Params
    opt_state: AdamState
    step: int

    def tree(self, ema_only: bool = False) -> dict:
        """The checkpoint tree (the JAX trainer's `_state_dict`)."""
        step = torch.tensor(self.step, dtype=torch.int32)
        ema = {k: v.detach() for k, v in self.ema_params.items()}
        if ema_only:
            return {"ema_params": ema, "step": step}
        return {"params": {k: v.detach() for k, v in self.params.items()},
                "ema_params": ema,
                "opt_state": {"count": self.opt_state.count, "mu": self.opt_state.mu,
                              "nu": self.opt_state.nu},
                "step": step}

    @classmethod
    def from_tree(cls, tree: dict) -> "StageState":
        opt = tree["opt_state"]
        return cls(params={k: nn.Parameter(v.float()) for k, v in tree["params"].items()},
                   ema_params={k: v.float() for k, v in tree["ema_params"].items()},
                   opt_state=AdamState(opt["count"].cpu().to(torch.int32), opt["mu"], opt["nu"]),
                   step=int(tree["step"]))


class Trainer:
    def __init__(
        self,
        cascade: Cascade,
        *,
        only_train_unet_number: Optional[int] = None,
        lr: float = 1e-4,
        eps: float = 1e-8,
        betas: tuple = (0.9, 0.99),
        max_grad_norm: Optional[float] = None,
        ema_decay: float = 0.9999,
        grad_accum_chunks: int = 1,
        seed: int = 0,
        phase_hook: Optional[Callable[[str], None]] = None,
    ):
        """`phase_hook(name)`, if given, is called as each part of a train
        step begins ("forward", "backward" for each accumulation chunk, then
        "update") and as the step ends ("end"): a place to record timings."""
        self.cascade = cascade
        self.device = cascade.device
        self.only_train_unet_number = only_train_unet_number
        self.lr, self.eps, self.betas = lr, eps, betas
        self.max_grad_norm = max_grad_norm
        self.ema_decay = ema_decay
        self.grad_accum_chunks = grad_accum_chunks
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.phase_hook = phase_hook
        self.last_grad_norm: Optional[float] = None  # global norm before clipping
        self._states: Dict[int, StageState] = {}

    # ---- state --------------------------------------------------------------

    def _check_stage(self, unet_number: int) -> None:
        if (self.only_train_unet_number is not None
                and unet_number != self.only_train_unet_number):
            # the reference's FixedNullUnet guard: training a stage this
            # process does not own is a bug
            raise ValueError(f"trainer configured for stage {self.only_train_unet_number} "
                             f"only, got stage {unet_number}")

    def state(self, unet_number: int) -> StageState:
        if unet_number not in self._states:
            self._init_stage(unet_number)
        return self._states[unet_number]

    def _init_stage(self, unet_number: int) -> None:
        self._check_stage(unet_number)
        fresh = self.cascade.init_stage_params(unet_number, self.generator)
        self._states[unet_number] = StageState(
            params={k: nn.Parameter(v) for k, v in fresh.items()},
            ema_params={k: v.clone() for k, v in fresh.items()},
            opt_state=AdamState.zeros_like(fresh),
            step=0)

    def set_state(self, unet_number: int, state: StageState) -> None:
        """Replace a stage's state, e.g. with `convert.from_flax_state`'s."""
        self._check_stage(unet_number)
        self._states[unet_number] = state

    def num_steps_taken(self, unet_number: int) -> int:
        return self._states[unet_number].step if unet_number in self._states else 0

    def drop_state(self, unet_number: int) -> None:
        """Release a stage's state; the next access initialises it afresh."""
        self._states.pop(int(unet_number), None)

    # ---- steps --------------------------------------------------------------

    def _phase(self, name: str) -> None:
        if self.phase_hook is not None:
            self.phase_hook(name)

    def _batch(self, batch: Mapping) -> Dict[str, Tensor]:
        if batch is None:
            raise ValueError("no dataset is attached to the port's Trainer: pass a batch")
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()
                if v is not None}

    def _loss(self, params: Params, unet_number: int, batch: Dict[str, Tensor],
              draws: Optional[Draws]) -> Tensor:
        return self.cascade.stage_loss(
            params, unet_number, self.generator, batch["images"],
            text_embeds=batch.get("text_embeds"), cond_images=batch.get("cond_images"),
            draws=draws)

    def train_step(self, unet_number: int, batch: Mapping,
                   draws: Optional[Sequence[Optional[Draws]]] = None) -> float:
        """One update of stage `unet_number` on `batch` ({"images": ...,
        optionally "text_embeds", "cond_images"}); returns the loss, the
        mean over the accumulation chunks. `draws`, one mapping per chunk,
        supplies `stage_loss`'s random values (see `Cascade.stage_loss`)."""
        state = self.state(unet_number)
        batch = self._batch(batch)
        chunks = self.grad_accum_chunks
        if draws is not None and len(draws) != chunks:
            raise ValueError(f"{len(draws)} draws for {chunks} accumulation chunks")
        n = batch["images"].shape[0]
        if n % chunks:
            raise ValueError(f"batch {n} is not a multiple of grad_accum_chunks={chunks}")
        params = list(state.params.values())
        grads, loss = None, 0.0
        for i in range(chunks):
            sub = {k: v.reshape((chunks, v.shape[0] // chunks) + v.shape[1:])[i]
                   for k, v in batch.items()}
            self._phase("forward")
            chunk_loss = self._loss(state.params, unet_number, sub,
                                    None if draws is None else draws[i])
            self._phase("backward")
            g = torch.autograd.grad(chunk_loss, params)
            if grads is None:
                grads = list(g)
            else:
                torch._foreach_add_(grads, g)
            loss = loss + chunk_loss.detach()
            del g, chunk_loss
        self._phase("update")
        with torch.no_grad():
            if chunks > 1:
                torch._foreach_div_(grads, chunks)
                loss = loss / chunks
            if self.max_grad_norm is not None:
                grads, norm = clip_by_global_norm(grads, self.max_grad_norm)
            else:
                norm = global_norm(grads)
            self.last_grad_norm = float(norm)
            adam_update(state.params, grads, state.opt_state, self.lr, *self.betas, self.eps)
            del grads
            ema_update(state.ema_params, state.params, ema_decay(self.ema_decay, state.step))
            state.step += 1
        self._phase("end")
        return float(loss)

    def valid_step(self, unet_number: int, batch: Mapping) -> float:
        with torch.no_grad():
            return float(self._loss(self.state(unet_number).params, unet_number,
                                    self._batch(batch), None))

    def sample(self, *, use_ema: bool = True, **kwargs):
        """`Cascade.sample` with (by default) the EMA weights of every stage
        this trainer holds (None for the others)."""
        params = []
        for n in range(1, self.cascade.config.num_stages + 1):
            st = self._states.get(n)
            params.append(None if st is None else (st.ema_params if use_ema else st.params))
        return self.cascade.sample(params, self.generator, **kwargs)

    # ---- checkpoints ----------------------------------------------------------

    def save(self, path, *, ema_only: bool = False) -> None:
        """Save every stage held. `ema_only` writes a serving checkpoint: the
        EMA weights and step of each stage (a quarter of the bytes); restore
        it with `load(..., partial=True)`."""
        tree = {str(n): st.tree(ema_only) for n, st in self._states.items()}
        save_checkpoint(path, tree, metadata={"stages": sorted(self._states),
                                              "cascade": self.cascade.config.name})

    def _abstract_tree(self, unet_number: int) -> dict:
        """Names, shapes and dtypes of a stage's checkpoint tree, on the meta
        device: the target of a full restore, which allocates nothing else."""
        shapes = init_stage_params(self.cascade.config, unet_number, device="meta")
        state = StageState(shapes, shapes, AdamState(
            torch.zeros((), dtype=torch.int32, device="meta"), shapes, shapes), 0)
        tree = state.tree()
        tree["step"] = tree["step"].to("meta")
        return tree

    def load(self, path, *, noop_if_not_exist: bool = False, partial: bool = False) -> bool:
        """Restore the stages a checkpoint holds. A full restore replaces
        their state (dropped first, so a large stage is not held twice);
        `partial=True` keeps the current value of every leaf the file does
        not hold (e.g. an `ema_only` checkpoint merged into a train state)."""
        if not checkpoint_exists(path):
            if noop_if_not_exist:
                return False
            raise FileNotFoundError(path)
        stages = [int(n) for n in load_metadata(path).get("stages", [])]
        target = {}
        for n in stages:
            if partial:
                target[str(n)] = self.state(n).tree()
            else:
                self.drop_state(n)
                target[str(n)] = self._abstract_tree(n)
        try:
            restored = load_checkpoint(path, target, partial=partial, map_location=self.device)
        except Exception as e:
            if partial:
                raise
            raise RuntimeError(
                f"restore of {path} failed after dropping the live state of stages {stages}; "
                "those stages initialise afresh on next access, so do not keep using this "
                "trainer's old weights: they are gone") from e
        for n_str, tree in restored.items():
            self._states[int(n_str)] = StageState.from_tree(tree)
        return True

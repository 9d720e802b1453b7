"""Cascade — the Imagen-equivalent.

Port of `kidney_diffusion_tpu/cascade.py`: per-stage continuous-time
Gaussian diffusion; `sample_stage` (uint8 wire in and out, low-res noise
augmentation at `lowres_sample_noise_level`, the bf16 weight cast, the
doubled-batch classifier-free guidance branch, and the DDPM / DDIM /
DPM-Solver++ samplers) and `sample` across a window of stages; and the
training loss `stage_loss` (the stage-size target, the low-res conditioning
built from the batch with noise augmentation, one random crop for both,
`cond_images` and the text-conditioning drop).

Parameters are dicts of tensors owned by the caller, keyed by the Flax
parameter paths (`convert.py`); a `Cascade` holds configs only. Public APIs
take and return NHWC images in [0, 1]; diffusion runs in [-1, 1].

JAX's threefry streams cannot be reproduced in torch: `stage_loss` draws
from a `torch.Generator` in the order JAX splits its key (time, noise,
crop, aug, aug-noise, drop), and a `draws` mapping can supply any of them.

`sample_stage` builds its stage's inference model (every parameter cast to
the compute dtype) on each call, unless the caller passes one from
`stage_model`: the gigapixel orchestrator builds each stage's model once
per level and hands it to every wave chunk, the counterpart of the JAX
package's jit cache, which takes the parameters as arguments.

Not ported yet: the EDM sampler and loss, `stage_distill_loss` and
`spatial_shard`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from .convert import Params, build_model, init_stage_params
from .core.diffusion import (
    NoiseSource,
    ddim_sample_loop,
    diffusion_loss,
    dpmpp_sample_loop,
    noise_drawer,
    sample_loop,
)
from .core.schedules import GaussianDiffusion
from .device import resolve_device
from .models.configs import CascadeConfig
from .models.unet import resize_nearest

Tensor = torch.Tensor


def normalize_img(x: Tensor) -> Tensor:
    return x.float() * 2.0 - 1.0


def unnormalize_img(x: Tensor) -> Tensor:
    return torch.clamp(x.float() * 0.5 + 0.5, 0.0, 1.0)


def linear_resize_weights(n_in: int, n_out: int, device=None) -> Tensor:
    """(n_in, n_out) fp32 weights of `jax.image.resize(method="linear")`
    along one axis (`jax._src.image.scale.compute_weight_mat`, antialias on):
    a triangle kernel at the output pixel centres, widened by n_in / n_out
    when downsampling, each column normalised to sum 1."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs()
    w = torch.clamp(1.0 - dist / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).float().to(device)


def resize_image_to(x: Tensor, size: int, method: str = "nearest") -> Tensor:
    """Resize an NHWC batch to (size, size) as `jax.image.resize` does
    ("nearest" or "linear", the latter antialiased when downsampling); a
    no-op when already that size."""
    h, w = x.shape[1], x.shape[2]
    if h == size and w == size:
        return x
    if method == "nearest":
        return resize_nearest(x, size, size)
    if method != "linear":
        raise NotImplementedError(f"resize method {method!r}")
    wh = linear_resize_weights(h, size, x.device)
    ww = linear_resize_weights(w, size, x.device)
    return torch.einsum("bhwc,hi,wj->bijc", x.float(), wh, ww)


def random_crop_pair(ys: Tensor, xs: Tensor, crop: int, *imgs: Optional[Tensor]) -> tuple:
    """`_random_crop_pair` with its offsets drawn: image i of every input
    cropped to rows ys[i]:ys[i]+crop, columns xs[i]:xs[i]+crop (None stays
    None)."""
    span = torch.arange(crop, device=ys.device)
    rows = (ys[:, None] + span)[:, :, None]  # (b, crop, 1)
    cols = (xs[:, None] + span)[:, None, :]  # (b, 1, crop)
    items = torch.arange(ys.shape[0], device=ys.device)[:, None, None]
    return tuple(None if img is None else img[items, rows, cols] for img in imgs)


def stage_sampler_steps(val, unet_number: int, num_stages: Optional[int] = None) -> int:
    """Resolve a per-stage sampler step count: an int / 1-sequence applies to
    every stage, a sequence is indexed by stage number. When `num_stages` is
    known, any other sequence length is refused — clamping a typo'd
    `(25, 25)` to 25/25/25 would serve the 1024² stage at 6x the intended
    cost."""
    if isinstance(val, (tuple, list)):
        if num_stages is not None and len(val) not in (1, num_stages):
            raise ValueError(
                f"per-stage sampler step sequence {tuple(val)} has {len(val)} entries "
                f"but the cascade has {num_stages} stages; pass one entry per stage "
                f"(or a single int)"
            )
        return int(val[min(unet_number - 1, len(val) - 1)])
    return int(val)


def _img_from_wire(v: Optional[Tensor], device) -> Optional[Tensor]:
    """uint8 [0, 255] -> fp32 [0, 1]; other dtypes -> fp32."""
    if v is None:
        return None
    v = torch.as_tensor(v, device=device)
    if not torch.is_floating_point(v):
        return v.float() / 255.0
    return v.float()


class Cascade:
    """Stage configs + diffusion processes for one cascade config, on one
    device (`"cuda"` by default; `"cpu"` runs the plain versions)."""

    def __init__(self, config: CascadeConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.diffusions = tuple(
            GaussianDiffusion(st.timesteps, st.noise_schedule) for st in config.stages
        )
        self.lowres_diffusion = GaussianDiffusion(1000, config.lowres_noise_schedule)

    def init_stage_params(self, unet_number: int,
                          generator: Optional[torch.Generator] = None) -> Params:
        """Fresh fp32 parameters of stage `unet_number` on this device."""
        return init_stage_params(self.config, unet_number, generator, self.device)

    def stage_loss(
        self,
        params: Params,
        unet_number: int,
        generator: Optional[torch.Generator],
        images: Tensor,
        *,
        text_embeds: Optional[Tensor] = None,
        cond_images: Optional[Tensor] = None,
        draws: Optional[Mapping[str, Tensor]] = None,
    ) -> Tensor:
        """Mean diffusion loss of one stage on a batch of [0, 1] images
        (uint8 [0, 255] accepted) at any size >= the stage size: the target
        is the batch resized (linear) to the stage size, the low-res
        conditioning the batch resized (linear) to the previous stage's size
        and back (nearest), both cropped alike to `random_crop_size`.

        While grad is enabled and `params` require grad, the model is built
        on them (`nn.Parameter`s, see `build_model(trainable=True)`), so the
        loss's gradient reaches them. Random values come from `generator`
        (on this device) in JAX's order; `draws` supplies any of them
        instead, by name: "times" (B,), "noise" (the target's shape),
        "crop_ys" and "crop_xs" (B,) int, "aug_times" (B,), "aug_noise" (the
        low-res conditioning's shape), "drop" (B,) 0/1."""
        dev = self.device
        cfg = self.config
        st = cfg.stage(unet_number)
        if st.sampler == "edm":
            raise NotImplementedError("the EDM loss is not ported yet")
        gd = self.diffusions[unet_number - 1]
        draws = dict(draws or {})

        images = _img_from_wire(images, dev)
        b, _, _, c = images.shape
        size = st.image_size
        crop = st.random_crop_size
        out = crop if crop is not None else size

        def draw(name, sample, *args):
            """`draws[name]` if given, else `sample(*args)` from the generator."""
            val = draws.pop(name, None)
            return sample(*args) if val is None else torch.as_tensor(val, device=dev)

        def uniform(scale=1.0):
            return torch.rand((b,), generator=generator, device=dev) * scale

        def normal(shape):
            return torch.randn(shape, generator=generator, device=dev)

        def offset():
            return torch.randint(0, size - crop + 1, (b,), generator=generator, device=dev)

        times = draw("times", uniform)
        noise = draw("noise", normal, (b, out, out, c))

        x_start = normalize_img(resize_image_to(images, size, "linear"))
        lowres = None
        if st.unet.lowres_cond:
            prev = cfg.stage(unet_number - 1).image_size
            lowres = normalize_img(resize_image_to(
                resize_image_to(images, prev, "linear"), size, "nearest"))
        if crop is not None:
            ys, xs = draw("crop_ys", offset), draw("crop_xs", offset)
            x_start, lowres = random_crop_pair(ys, xs, crop, x_start, lowres)

        model_kwargs: Dict[str, Tensor] = {}
        if lowres is not None:  # noise-conditioning augmentation
            aug_times = draw("aug_times", uniform, cfg.lowres_max_aug_level)
            aug_noise = draw("aug_noise", normal, tuple(lowres.shape))
            model_kwargs["lowres_cond_img"], *_ = self.lowres_diffusion.q_sample(
                lowres, aug_times, aug_noise)
            model_kwargs["lowres_noise_times"] = aug_times
        if st.unet.cond_images_channels:
            if cond_images is None:
                raise ValueError(f"stage {unet_number} needs cond_images")
            model_kwargs["cond_images"] = _img_from_wire(cond_images, dev)
        if cfg.condition_on_text and st.unet.text_embed_dim is not None:
            if text_embeds is None:
                raise ValueError("this cascade is conditioned on text: pass text_embeds")
            model_kwargs["text_embeds"] = torch.as_tensor(text_embeds, device=dev)
            model_kwargs["cond_drop_mask"] = draw(
                "drop", lambda: uniform() < cfg.cond_drop_prob).float()
        if draws:
            raise ValueError(f"draws this stage does not make: {sorted(draws)}")

        trainable = torch.is_grad_enabled() and any(p.requires_grad for p in params.values())
        model = build_model(st.unet, params, trainable=trainable)
        losses = diffusion_loss(gd, lambda x_t, t: model(x_t, t, **model_kwargs),
                                x_start, times, noise, objective=st.pred_objective)
        return losses.mean()

    def stage_model(self, params: Params, unet_number: int):
        """The inference U-Net of stage `unet_number` on `params`, every
        parameter cast to the compute dtype on this device (int8 weights are
        quantized at its first forward). Pass it to `sample_stage` as
        `model` to reuse it across calls with the same parameters."""
        unet = self.config.stage(unet_number).unet
        return build_model(unet, {k: v.to(device=self.device, dtype=unet.compute_dtype)
                                  for k, v in params.items()})

    @torch.no_grad()
    def sample_stage(
        self,
        params: Params,
        unet_number: int,
        noise: NoiseSource,
        *,
        batch_size: int,
        lowres_image: Optional[Tensor] = None,
        text_embeds: Optional[Tensor] = None,
        cond_images: Optional[Tensor] = None,
        inpaint_images: Optional[Tensor] = None,
        inpaint_masks: Optional[Tensor] = None,
        inpaint_resample_times: int = 1,
        cond_scale: float = 1.0,
        use_ddim: bool = False,
        ddim_steps: int = 0,
        ddim_eta: float = 0.0,
        dpmpp_steps: int = 0,
        output_dtype: Optional[str] = None,
        output_split: bool = False,
        model=None,
    ) -> Tensor:
        """Sample one stage. `lowres_image` is the previous stage's [0, 1]
        output at any size; image inputs may be uint8 [0, 255] or float.
        Returns [0, 1] images at this stage's size, or uint8 [0, 255] with
        `output_dtype="uint8"`; with `output_split=True` a tuple of
        `batch_size` per-image tensors (views of one batch) instead.
        `noise` is a `torch.Generator` on this device or a callable
        `draw(shape)` (see `core.diffusion`). `model`: this stage's model
        from `stage_model(params, unet_number)`, built on this call if None."""
        dev = self.device
        cfg = self.config
        st = cfg.stage(unet_number)
        if st.sampler == "edm":
            raise NotImplementedError("the EDM sampler is not ported yet")
        gd = self.diffusions[unet_number - 1]
        size = st.image_size
        lowres_image = _img_from_wire(lowres_image, dev)
        cond_images = _img_from_wire(cond_images, dev)
        inpaint_images = _img_from_wire(inpaint_images, dev)
        if inpaint_masks is not None:
            inpaint_masks = torch.as_tensor(inpaint_masks, device=dev).float()
        if text_embeds is not None:
            text_embeds = torch.as_tensor(text_embeds, device=dev)

        if model is None:
            model = self.stage_model(params, unet_number)
        draw = noise_drawer(noise, dev)

        model_kwargs: Dict[str, Tensor] = {}
        if st.unet.lowres_cond:
            if lowres_image is None:
                raise ValueError(f"stage {unet_number} needs a lowres image")
            lowres = normalize_img(resize_image_to(lowres_image, size))
            noise_level = torch.full((batch_size,), cfg.lowres_sample_noise_level,
                                     dtype=torch.float32, device=dev)
            lowres_noised, *_ = self.lowres_diffusion.q_sample(
                lowres, noise_level, draw(lowres.shape))
            model_kwargs["lowres_cond_img"] = lowres_noised
            model_kwargs["lowres_noise_times"] = noise_level
        if st.unet.cond_images_channels:
            if cond_images is None:
                raise ValueError(f"stage {unet_number} needs cond_images")
            model_kwargs["cond_images"] = cond_images

        has_text = cfg.condition_on_text and st.unet.text_embed_dim is not None
        if has_text and text_embeds is None:
            raise ValueError("this cascade is conditioned on text: pass text_embeds")
        zeros = torch.zeros((batch_size,), dtype=torch.float32, device=dev)

        if has_text and cond_scale != 1.0:
            # doubled-batch CFG: one forward evaluates cond + uncond
            doubled = {k: torch.cat([v, v], dim=0) for k, v in model_kwargs.items()}
            doubled["text_embeds"] = torch.cat([text_embeds, text_embeds], dim=0)
            doubled["cond_drop_mask"] = torch.cat([zeros, torch.ones_like(zeros)], dim=0)

            def denoise_fn(x_t, t):
                pred2 = model(torch.cat([x_t, x_t], dim=0), torch.cat([t, t], dim=0), **doubled)
                cond_pred, uncond_pred = torch.chunk(pred2, 2, dim=0)
                return uncond_pred + (cond_pred - uncond_pred) * cond_scale
        else:
            if has_text:
                model_kwargs["text_embeds"] = text_embeds
                model_kwargs["cond_drop_mask"] = zeros

            def denoise_fn(x_t, t):
                return model(x_t, t, **model_kwargs)

        shape = (batch_size, size, size, cfg.channels)
        loop_kw = dict(
            objective=st.pred_objective,
            inpaint_images=normalize_img(inpaint_images) if inpaint_images is not None else None,
            inpaint_masks=inpaint_masks,
            inpaint_resample_times=inpaint_resample_times,
            device=dev,
        )
        if dpmpp_steps > 0:
            out = dpmpp_sample_loop(gd, denoise_fn, shape, draw, num_steps=dpmpp_steps, **loop_kw)
        elif use_ddim and ddim_steps > 0:
            out = ddim_sample_loop(gd, denoise_fn, shape, draw, num_steps=ddim_steps,
                                   eta=ddim_eta, **loop_kw)
        else:
            out = sample_loop(gd, denoise_fn, shape, draw, **loop_kw)
        out = unnormalize_img(out)
        if output_dtype == "uint8":
            out = torch.round(out * 255.0).to(torch.uint8)
        elif output_dtype is not None:
            out = out.to(getattr(torch, output_dtype))
        return tuple(out.unbind(0)) if output_split else out

    def sample(
        self,
        params_per_stage: Sequence[Optional[Params]],
        noise: NoiseSource,
        *,
        batch_size: int,
        text_embeds: Optional[Tensor] = None,
        cond_images: Optional[Tensor] = None,
        start_image: Optional[Tensor] = None,
        start_at_unet_number: int = 1,
        stop_at_unet_number: Optional[int] = None,
        inpaint_images: Optional[Tensor] = None,
        inpaint_masks: Optional[Tensor] = None,
        inpaint_resample_times: int = 1,
        cond_scale: float = 1.0,
        ddim_steps=0,
        ddim_eta: float = 0.0,
        dpmpp_steps=0,
        output_dtype: Optional[str] = None,
    ) -> Tensor:
        """Cascade sampling across a window of stages; each stage's [0, 1]
        output feeds the next as its low-res image. Step counts may be
        per-stage sequences (`stage_sampler_steps`); per stage, DPM++ takes
        precedence over DDIM. `output_dtype` applies to the last stage's
        output (`"uint8"`: [0, 255])."""
        stop = stop_at_unet_number or self.config.num_stages
        img = start_image
        for n in range(start_at_unet_number, stop + 1):
            st = self.config.stage(n)
            ds = stage_sampler_steps(ddim_steps, n, self.config.num_stages)
            ps = stage_sampler_steps(dpmpp_steps, n, self.config.num_stages)
            stage_inpaint_images = stage_inpaint_masks = None
            if inpaint_images is not None:
                stage_inpaint_images = resize_image_to(
                    _img_from_wire(inpaint_images, self.device), st.image_size)
                m = torch.as_tensor(inpaint_masks, device=self.device)
                if m.ndim == 3:
                    m = m[..., None]
                stage_inpaint_masks = resize_image_to(m, st.image_size)[..., 0]
            img = self.sample_stage(
                params_per_stage[n - 1], n, noise,
                batch_size=batch_size,
                lowres_image=img,
                text_embeds=text_embeds,
                cond_images=cond_images,
                inpaint_images=stage_inpaint_images,
                inpaint_masks=stage_inpaint_masks,
                inpaint_resample_times=inpaint_resample_times,
                cond_scale=cond_scale,
                use_ddim=ds > 0,
                ddim_steps=ds,
                ddim_eta=ddim_eta,
                dpmpp_steps=ps,
                output_dtype=output_dtype if n == stop else None,
            )
        return img

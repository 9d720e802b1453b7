"""Stage-level diffusion engine: the training loss and the sampling loops.

Port of `kidney_diffusion_tpu/core/diffusion.py`: `diffusion_loss` (the
per-example MSE of the noise / v / x_start objectives), dynamic / static x0
thresholding, the ancestral DDPM step, the RePaint-masked reverse loop with
resample rounds, and the DDPM, DDIM and DPM-Solver++(2M) loops. The model is
a `denoise_fn(x_t, times) -> prediction` with guidance and conditioning
bound by the caller.

JAX's threefry streams cannot be reproduced in torch, so every loop takes
its Gaussian noise from a `noise` source: a `torch.Generator` (the default
use), or a callable `draw(shape) -> Tensor` that the tests feed with noise
drawn by JAX. Draws happen in a fixed order: the initial x, then per step
(and per resample round) the known-region noise, the sampler's own noise
(ancestral steps, or DDIM with eta > 0), and the re-noising noise.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from .schedules import GaussianDiffusion, linspace_pairs, right_pad_dims_to

Tensor = torch.Tensor
DenoiseFn = Callable[[Tensor, Tensor], Tensor]
NoiseSource = Union[torch.Generator, Callable[[tuple], Tensor]]


def noise_drawer(noise: NoiseSource, device) -> Callable[[tuple], Tensor]:
    """`draw(shape) -> fp32 N(0, 1) tensor on device` from a noise source."""
    if isinstance(noise, torch.Generator):
        return lambda shape: torch.randn(shape, generator=noise, dtype=torch.float32,
                                         device=device)
    return lambda shape: torch.as_tensor(noise(tuple(shape)), dtype=torch.float32,
                                         device=device)


def dynamic_threshold(x0: Tensor, percentile: float = 0.95,
                      max_quantile_elems: int = 16384) -> Tensor:
    """Imagen dynamic thresholding: clamp to the per-sample |x0| percentile,
    then rescale into [-1, 1]. For large images the percentile comes from a
    strided spatial subsample of at most `max_quantile_elems` elements, as
    the JAX package does."""
    b = x0.shape[0]
    sample = x0
    if x0.ndim == 4:
        n = x0.shape[1] * x0.shape[2] * x0.shape[3]
        stride = 1
        while n // (stride * stride) > max_quantile_elems:
            stride *= 2
        if stride > 1:
            sample = x0[:, ::stride, ::stride, :]
    flat = sample.reshape(b, -1).abs()
    s = torch.quantile(flat, percentile, dim=-1, interpolation="linear")
    s = right_pad_dims_to(x0, torch.clamp(s, min=1.0))
    return torch.clamp(x0, -s, s) / s


def static_threshold(x0: Tensor) -> Tensor:
    return torch.clamp(x0, -1.0, 1.0)


def pred_to_x_start(diffusion: GaussianDiffusion, x_t: Tensor, times: Tensor,
                    pred: Tensor, *, objective: str) -> Tensor:
    if objective == "noise":
        return diffusion.predict_start_from_noise(x_t, times, pred)
    if objective == "v":
        return diffusion.predict_start_from_v(x_t, times, pred)
    if objective == "x_start":
        return pred
    raise ValueError(f"unknown objective {objective!r}")


def _threshold(x0, use_dynamic_threshold, percentile):
    return dynamic_threshold(x0, percentile) if use_dynamic_threshold else static_threshold(x0)


def diffusion_loss(diffusion: GaussianDiffusion, denoise_fn: DenoiseFn, x_start: Tensor,
                   times: Tensor, noise: Tensor, *, objective: str = "noise") -> Tensor:
    """Per-example MSE loss at continuous times, shape (batch,): the model's
    prediction at x_t = q_sample(x_start, t, noise) against the objective's
    target (the noise, v = alpha * noise - sigma * x_start, or x_start)."""
    x_start, noise = x_start.float(), noise.float()
    x_t, *_ = diffusion.q_sample(x_start, times, noise)
    pred = denoise_fn(x_t, times).float()
    if objective == "noise":
        target = noise
    elif objective == "v":
        target = diffusion.calculate_v(x_start, times, noise)
    elif objective == "x_start":
        target = x_start
    else:
        raise ValueError(f"unknown objective {objective!r}")
    return torch.mean((pred - target) ** 2, dim=tuple(range(1, x_start.ndim)))


def ddpm_step(diffusion: GaussianDiffusion, denoise_fn: DenoiseFn, x_t: Tensor,
              t: Tensor, t_next: Tensor, noise: Tensor, *, objective: str,
              use_dynamic_threshold: bool = True,
              threshold_percentile: float = 0.95) -> Tensor:
    """One ancestral step x_t -> x_{t_next}. `t`, `t_next` shape (batch,)."""
    pred = denoise_fn(x_t, t).float()
    x0 = pred_to_x_start(diffusion, x_t, t, pred, objective=objective)
    x0 = _threshold(x0, use_dynamic_threshold, threshold_percentile)
    mean, _, log_var = diffusion.q_posterior(x0, x_t, t, t_next)
    nonzero = right_pad_dims_to(x_t, (t_next > 0).float())  # no noise at t_next == 0
    return mean + nonzero * torch.exp(0.5 * log_var) * noise


def masked_reverse_loop(diffusion: GaussianDiffusion, x: Tensor, draw, time_pairs: Tensor,
                        update, extra0, *, inpaint_images: Optional[Tensor],
                        inpaint_masks: Optional[Tensor],
                        inpaint_resample_times: int) -> Tensor:
    """Shared reverse-process scaffolding (`_masked_reverse_scan`): a loop
    over (t, t_next) pairs with the RePaint known-region contract —
    `inpaint_masks` is 1 where pixels are KNOWN: blend the forward-noised
    known image in before each update, optionally re-noise and resample,
    and restore the exact known pixels at the end.

    `update(x, t, t_next, extra) -> (x, extra)` is the per-step rule; it
    draws its own noise, if any, from the same source."""
    batch = x.shape[0]
    has_inpaint = inpaint_images is not None and inpaint_masks is not None
    if has_inpaint:
        inpaint_images = inpaint_images.float()
        mask = inpaint_masks.float()
        if mask.ndim == x.ndim - 1:  # (B, H, W) -> (B, H, W, 1)
            mask = mask[..., None]
    rounds = max(int(inpaint_resample_times), 1) if has_inpaint else 1
    extra = extra0
    for t_val, t_next_val in time_pairs.tolist():
        t = torch.full((batch,), t_val, dtype=torch.float32, device=x.device)
        t_next = torch.full((batch,), t_next_val, dtype=torch.float32, device=x.device)
        for r in range(rounds):
            if has_inpaint:
                noised, *_ = diffusion.q_sample(inpaint_images, t, draw(x.shape))
                x = x * (1.0 - mask) + noised * mask
            x, extra = update(x, t, t_next, extra)
            if r < rounds - 1 and t_next_val > 0:  # re-noise back to t
                x = diffusion.q_sample_from_to(x, t_next, t, draw(x.shape))
    if has_inpaint:
        x = x * (1.0 - mask) + inpaint_images * mask
    return torch.clamp(x, -1.0, 1.0)


def sample_loop(diffusion: GaussianDiffusion, denoise_fn: DenoiseFn, shape: tuple,
                noise: NoiseSource, *, objective: str = "noise",
                use_dynamic_threshold: bool = True, threshold_percentile: float = 0.95,
                init_image: Optional[Tensor] = None,
                inpaint_images: Optional[Tensor] = None,
                inpaint_masks: Optional[Tensor] = None,
                inpaint_resample_times: int = 1, device=None) -> Tensor:
    """Full DDPM reverse process (ancestral sampler)."""
    draw = noise_drawer(noise, device)
    x = draw(shape) if init_image is None else init_image.float()

    def update(x, t, t_next, extra):
        step_noise = draw(x.shape)
        return ddpm_step(diffusion, denoise_fn, x, t, t_next, step_noise,
                         objective=objective, use_dynamic_threshold=use_dynamic_threshold,
                         threshold_percentile=threshold_percentile), extra

    return masked_reverse_loop(
        diffusion, x, draw, diffusion.sampling_time_pairs(), update, None,
        inpaint_images=inpaint_images, inpaint_masks=inpaint_masks,
        inpaint_resample_times=inpaint_resample_times)


def ddim_sample_loop(diffusion: GaussianDiffusion, denoise_fn: DenoiseFn, shape: tuple,
                     noise: NoiseSource, *, objective: str = "noise", num_steps: int = 50,
                     eta: float = 0.0, use_dynamic_threshold: bool = True,
                     threshold_percentile: float = 0.95,
                     inpaint_images: Optional[Tensor] = None,
                     inpaint_masks: Optional[Tensor] = None,
                     inpaint_resample_times: int = 1, device=None) -> Tensor:
    """DDIM sampler (Song et al. 2020) on the continuous-time schedule."""
    draw = noise_drawer(noise, device)
    x = draw(shape)

    def update(x, t, t_next, extra):
        pred = denoise_fn(x, t).float()
        x0 = pred_to_x_start(diffusion, x, t, pred, objective=objective)
        x0 = _threshold(x0, use_dynamic_threshold, threshold_percentile)
        eps = diffusion.predict_noise_from_start(x, t, x0)
        log_snr = right_pad_dims_to(x, diffusion.log_snr(t))
        log_snr_next = right_pad_dims_to(x, diffusion.log_snr(t_next))
        alpha, sigma = torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))
        alpha_next = torch.sqrt(torch.sigmoid(log_snr_next))
        sigma_next = torch.sqrt(torch.sigmoid(-log_snr_next))
        if eta > 0:
            ddim_sigma = (
                eta * sigma_next / torch.clamp(sigma, min=1e-8)
                * torch.sqrt(torch.clamp(
                    1.0 - (alpha / torch.clamp(alpha_next, min=1e-8)) ** 2, min=0.0))
            )
            dir_coeff = torch.sqrt(torch.clamp(sigma_next**2 - ddim_sigma**2, min=0.0))
            return alpha_next * x0 + dir_coeff * eps + ddim_sigma * draw(x.shape), extra
        return alpha_next * x0 + sigma_next * eps, extra

    return masked_reverse_loop(
        diffusion, x, draw, linspace_pairs(num_steps), update, None,
        inpaint_images=inpaint_images, inpaint_masks=inpaint_masks,
        inpaint_resample_times=inpaint_resample_times)


def dpmpp_sample_loop(diffusion: GaussianDiffusion, denoise_fn: DenoiseFn, shape: tuple,
                      noise: NoiseSource, *, objective: str = "noise", num_steps: int = 25,
                      use_dynamic_threshold: bool = True, threshold_percentile: float = 0.95,
                      inpaint_images: Optional[Tensor] = None,
                      inpaint_masks: Optional[Tensor] = None,
                      inpaint_resample_times: int = 1, device=None) -> Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022, Algorithm 2) in half-log-SNR time
    lambda = log(alpha/sigma); first order on the first and final steps and
    wherever there is no usable history (a RePaint re-entry at the same t)."""
    draw = noise_drawer(noise, device)
    batch = shape[0]
    x = draw(shape)

    def update(x, t, t_next, extra):
        x0_prev, lam_prev, is_first = extra
        pred = denoise_fn(x, t).float()
        x0 = pred_to_x_start(diffusion, x, t, pred, objective=objective)
        x0 = _threshold(x0, use_dynamic_threshold, threshold_percentile)
        lam = 0.5 * right_pad_dims_to(x, diffusion.log_snr(t))
        lam_next = 0.5 * right_pad_dims_to(x, diffusion.log_snr(t_next))
        h = lam_next - lam
        sigma = torch.sqrt(torch.sigmoid(-2.0 * lam))
        alpha_next = torch.sqrt(torch.sigmoid(2.0 * lam_next))
        sigma_next = torch.sqrt(torch.sigmoid(-2.0 * lam_next))
        h_prev = lam - lam_prev
        r2 = 2.0 * h_prev / torch.where(h.abs() < 1e-12, torch.full_like(h, 1e-12), h)
        r2 = torch.where(r2.abs() < 1e-12, torch.ones_like(r2), r2)  # keep 1/r2 finite
        d2 = (1.0 + 1.0 / r2) * x0 - (1.0 / r2) * x0_prev
        is_last = right_pad_dims_to(x, t_next <= 0.0)
        no_history = h_prev.abs() < 1e-8
        d = torch.where(is_first | is_last | no_history, x0, d2)
        x_new = (sigma_next / sigma) * x - alpha_next * torch.expm1(-h) * d
        return x_new, (x0, lam, torch.tensor(False, device=x.device))

    t1 = torch.ones((batch,), dtype=torch.float32, device=x.device)
    lam0 = 0.5 * right_pad_dims_to(x, diffusion.log_snr(t1))
    extra0 = (torch.zeros_like(x), lam0, torch.tensor(True, device=x.device))
    return masked_reverse_loop(
        diffusion, x, draw, linspace_pairs(num_steps), update, extra0,
        inpaint_images=inpaint_images, inpaint_masks=inpaint_masks,
        inpaint_resample_times=inpaint_resample_times)


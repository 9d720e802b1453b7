"""Continuous-time Gaussian diffusion schedules (log-SNR formulation).

Port of `kidney_diffusion_tpu/core/schedules.py`: cosine / linear log-SNR,
alpha / sigma, `q_sample`, `q_sample_from_to` (RePaint re-noising),
`q_posterior` and the eps / v / x0 conversions. All schedule math is fp32.

Conventions: continuous time t in [0, 1]; t=0 is clean data, t=1 is pure
noise. Sampling discretises [1, 0] into `num_timesteps` pairs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

Tensor = torch.Tensor


def right_pad_dims_to(x: Tensor, t: Tensor) -> Tensor:
    """Broadcast a per-batch scalar `t` against image-shaped `x`."""
    pad = x.ndim - t.ndim
    if pad <= 0:
        return t
    return t.reshape(t.shape + (1,) * pad)


def cosine_log_snr(t: Tensor, s: float = 0.008, eps: float = 1e-5) -> Tensor:
    """log SNR for the cosine schedule: alpha_bar(t) = cos²(((t+s)/(1+s))·π/2)."""
    arg = torch.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2
    return -torch.log(torch.clamp(arg - 1.0, min=eps))


def linear_log_snr(t: Tensor) -> Tensor:
    """log SNR for the (continuous) linear-beta schedule."""
    return -torch.log(torch.expm1(1e-4 + 10.0 * t**2))


_LOG_SNR_FNS = {"cosine": cosine_log_snr, "linear": linear_log_snr}


def log_snr_to_alpha_sigma(log_snr: Tensor) -> Tuple[Tensor, Tensor]:
    """alpha = sqrt(sigmoid(log_snr)), sigma = sqrt(sigmoid(-log_snr))."""
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))


def linspace_pairs(num_steps: int, device=None) -> Tensor:
    """(num_steps, 2) (t, t_next) pairs from t=1 down to t=0."""
    times = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)
    return torch.stack([times[:-1], times[1:]], dim=-1)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Continuous-time diffusion process with a fixed number of sampling steps."""

    num_timesteps: int = 1000
    schedule: str = "cosine"

    def __post_init__(self):
        if self.schedule not in _LOG_SNR_FNS:
            raise ValueError(f"unknown schedule {self.schedule!r}")

    def log_snr(self, t) -> Tensor:
        return _LOG_SNR_FNS[self.schedule](torch.as_tensor(t, dtype=torch.float32))

    def alpha_sigma(self, t) -> Tuple[Tensor, Tensor]:
        return log_snr_to_alpha_sigma(self.log_snr(t))

    def sample_random_times(self, generator: torch.Generator, batch: int,
                            device=None) -> Tensor:
        """Continuous training times t ~ U(0, 1), shape (batch,)."""
        return torch.rand((batch,), generator=generator, dtype=torch.float32,
                          device=device)

    def sampling_time_pairs(self, device=None) -> Tensor:
        """(num_timesteps, 2) array of (t, t_next) pairs, from t=1 down to 0."""
        return linspace_pairs(self.num_timesteps, device)

    def q_sample(self, x_start: Tensor, t: Tensor, noise: Tensor):
        """Diffuse clean data to time t. Returns (x_t, log_snr, alpha, sigma)."""
        log_snr = self.log_snr(t)
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_start, log_snr))
        x_t = alpha * x_start.float() + sigma * noise.float()
        return x_t, log_snr, alpha, sigma

    def q_sample_from_to(self, x_from: Tensor, from_t: Tensor, to_t: Tensor,
                         noise: Tensor) -> Tensor:
        """Re-noise a sample from `from_t` to a later time `to_t` (RePaint)."""
        x_from = x_from.float()
        alpha_from, sigma_from = log_snr_to_alpha_sigma(
            right_pad_dims_to(x_from, self.log_snr(from_t)))
        alpha_to, sigma_to = log_snr_to_alpha_sigma(
            right_pad_dims_to(x_from, self.log_snr(to_t)))
        var = torch.clamp(sigma_to**2 - (alpha_to / alpha_from) ** 2 * sigma_from**2, min=0.0)
        return x_from * (alpha_to / alpha_from) + torch.sqrt(var) * noise

    def q_posterior(self, x_start: Tensor, x_t: Tensor, t: Tensor, t_next: Tensor):
        """Mean / variance / log-variance of q(x_{t_next} | x_t, x_0)."""
        log_snr = right_pad_dims_to(x_t, self.log_snr(t))
        log_snr_next = right_pad_dims_to(x_t, self.log_snr(t_next))
        alpha, _ = log_snr_to_alpha_sigma(log_snr)
        alpha_next, sigma_next = log_snr_to_alpha_sigma(log_snr_next)
        c = -torch.expm1(log_snr - log_snr_next)  # 1 - SNR(t)/SNR(t_next)
        mean = alpha_next * (x_t * (1.0 - c) / alpha + c * x_start)
        variance = sigma_next**2 * c
        log_variance = torch.log(torch.clamp(variance, min=1e-20))
        return mean, variance, log_variance

    def predict_start_from_noise(self, x_t: Tensor, t: Tensor, noise: Tensor) -> Tensor:
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_t, self.log_snr(t)))
        return (x_t - sigma * noise) / torch.clamp(alpha, min=1e-8)

    def predict_start_from_v(self, x_t: Tensor, t: Tensor, v: Tensor) -> Tensor:
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_t, self.log_snr(t)))
        return alpha * x_t - sigma * v

    def predict_noise_from_start(self, x_t: Tensor, t: Tensor, x0: Tensor) -> Tensor:
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_t, self.log_snr(t)))
        return (x_t - alpha * x0) / torch.clamp(sigma, min=1e-8)

    def calculate_v(self, x_start: Tensor, t: Tensor, noise: Tensor) -> Tensor:
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_start, self.log_snr(t)))
        return alpha * noise - sigma * x_start

"""DDIM inversion: clean latents -> the noise trajectory (port of
``cvd_tpu/schedulers/inversion.py``).

The inversion helpers the reference vendors in
``animatediff/utils/util.py:75-130`` (next_step / get_noise_pred_single /
ddim_inversion): deterministic reverse DDIM, x_t -> x_{t+stride}, walking
the inference timesteps in ascending order from one stride below the first.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from cvd_tpu_torch.schedulers.ddim import DDIMScheduler, DDIMState


def ddim_inversion_step(scheduler: DDIMScheduler, state: DDIMState,
                        model_output: torch.Tensor, timestep: int,
                        sample: torch.Tensor) -> torch.Tensor:
    """One inversion update x_t -> x_{t+stride} (util.py:75-87). A negative
    ``timestep`` (the first step) takes the final alpha."""
    timestep = int(timestep)
    stride = scheduler.num_train_timesteps // state.num_inference_steps
    next_timestep = min(timestep + stride, scheduler.num_train_timesteps - 1)
    alpha_t = (state.alphas_cumprod[timestep] if timestep >= 0
               else state.final_alpha_cumprod)
    alpha_next = state.alphas_cumprod[next_timestep]
    one = np.float32(1.0)
    x0 = (sample - float((one - alpha_t) ** 0.5) * model_output) / float(alpha_t ** 0.5)
    direction = float((one - alpha_next) ** 0.5) * model_output
    return float(alpha_next ** 0.5) * x0 + direction


def ddim_invert(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                scheduler: DDIMScheduler, state: DDIMState,
                latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inversion loop (util.py:115-130). ``eps_fn(latents, t)`` -> the
    predicted noise, ``t`` an int clipped to >= 0. Returns (the final noisy
    latents, the trajectory [num_inference_steps, ...]: the latents after
    each step)."""
    stride = scheduler.num_train_timesteps // state.num_inference_steps
    lat, trajectory = latents, []
    for t in state.timesteps[::-1] - stride:
        eps = eps_fn(lat, max(int(t), 0))
        lat = ddim_inversion_step(scheduler, state, eps, int(t), lat)
        trajectory.append(lat)
    return lat, torch.stack(trajectory)

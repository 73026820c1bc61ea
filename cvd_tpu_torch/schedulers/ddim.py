"""DDIM scheduler with diffusers' DDIMScheduler semantics, eta = 0; the
defaults are what the reference configures (1000 train steps, linear betas
0.00085 -> 0.012, steps_offset=1, clip_sample=False) and a model config may
set ``beta_schedule`` and ``clip_sample`` (``io/model_config.py``) — port of
``cvd_tpu/schedulers/ddim.py``. Epsilon prediction and a final alpha of 1 are
fixed: nothing configures them, and the training loss regresses on the noise.
The tables are computed on the host in f64 and stored in f32; the per-step
scalars are f32, as in the JAX package."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMState:
    alphas_cumprod: np.ndarray      # [num_train_timesteps] f32
    final_alpha_cumprod: np.float32
    timesteps: np.ndarray           # [num_inference_steps] int, descending
    num_train_timesteps: int
    num_inference_steps: int


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    steps_offset: int = 1
    clip_sample: bool = False

    def _alphas_cumprod(self) -> np.ndarray:
        if self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, self.num_train_timesteps,
                                dtype=np.float64)
        elif self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                                self.num_train_timesteps, dtype=np.float64) ** 2
        else:
            raise ValueError(f"unsupported beta schedule {self.beta_schedule}")
        return np.cumprod(1.0 - betas)

    def set_timesteps(self, num_inference_steps: int) -> DDIMState:
        """The inference schedule (diffusers 'leading' spacing)."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        timesteps = ((np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
                     ).astype(np.int64) + self.steps_offset
        acp = self._alphas_cumprod()
        return DDIMState(acp.astype(np.float32), np.float32(1.0), timesteps,
                         self.num_train_timesteps, num_inference_steps)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def add_noise(self, state: DDIMState, original_samples: torch.Tensor,
                  noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps, timesteps [B]
        (ddim.py:150-161)."""
        acp = torch.from_numpy(state.alphas_cumprod).to(original_samples.device)
        acp = acp[timesteps.to(acp.device).long()]
        acp = acp.reshape(acp.shape + (1,) * (original_samples.ndim - acp.ndim))
        return acp ** 0.5 * original_samples + (1.0 - acp) ** 0.5 * noise

    def _alphas(self, state: DDIMState, timestep: int):
        """(alpha_cumprod at t, at the previous inference timestep), f32."""
        timestep = int(timestep)
        prev_timestep = timestep - self.num_train_timesteps // state.num_inference_steps
        a_prev = (state.alphas_cumprod[prev_timestep] if prev_timestep >= 0
                  else state.final_alpha_cumprod)
        return state.alphas_cumprod[timestep], a_prev

    def step(self, state: DDIMState, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor) -> torch.Tensor:
        """One DDIM update x_t -> x_{t-1} (diffusers DDIMScheduler.step, eta 0)."""
        a_t, a_prev = self._alphas(state, timestep)
        one = np.float32(1.0)
        sqrt_a, sqrt_b = float(a_t ** 0.5), float((one - a_t) ** 0.5)
        pred_x0 = (sample - sqrt_b * model_output) / sqrt_a
        if self.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
        pred_dir = float((one - a_prev) ** 0.5) * model_output
        return float(a_prev ** 0.5) * pred_x0 + pred_dir

    def renoise(self, state: DDIMState, sample: torch.Tensor, timestep: int,
                noise: torch.Tensor) -> torch.Tensor:
        """x_{t-1} back to x_t for multistep recurrent denoising:
        x * sqrt(a_t / a_{t-1}) + sqrt(1 - a_t / a_{t-1}) * noise
        (pipeline_animation_epi_advanced.py:700-705)."""
        a_t, a_prev = self._alphas(state, timestep)
        ratio = a_t / a_prev
        return float(ratio ** 0.5) * sample + float((np.float32(1.0) - ratio) ** 0.5) * noise

"""DDIM scheduler with diffusers' DDIMScheduler semantics, eta = 0; the
defaults are what the reference configures (1000 train steps, linear betas
0.00085 -> 0.012, steps_offset=1, clip_sample=False) and a model config may
set ``beta_schedule`` and ``clip_sample`` (``io/model_config.py``) — port of
``cvd_tpu/schedulers/ddim.py``. Epsilon prediction and a final alpha of 1 are
fixed: nothing configures them, and the training loss regresses on the noise.
The tables are computed on the host in f64 and stored in f32 tensors; the
per-step arithmetic is f32 tensors, as in the JAX package's traced form
(``cvd_tpu/schedulers/ddim.py:95-141``): the timestep is a tensor too, and
``step`` / ``renoise`` index the table on the sample's device, so a sampler
whose table is on the card computes a step without the host, and a CUDA
graph can replay it for any timestep."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMState:
    alphas_cumprod: torch.Tensor    # [num_train_timesteps] f32
    final_alpha_cumprod: np.float32
    timesteps: np.ndarray           # [num_inference_steps] int, descending (the host's loop)
    num_train_timesteps: int
    num_inference_steps: int

    def to(self, device) -> "DDIMState":
        """The state with its table on ``device``: a training step built on
        it adds noise without a copy from the host (which a CUDA graph's
        capture refuses)."""
        return dataclasses.replace(self, alphas_cumprod=self.alphas_cumprod.to(device))


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
        acp = torch.from_numpy(self._alphas_cumprod().astype(np.float32))
        return DDIMState(acp, np.float32(1.0), timesteps, self.num_train_timesteps,
                         num_inference_steps)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def add_noise(self, state: DDIMState, original_samples: torch.Tensor,
                  noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps, timesteps [B]
        (ddim.py:150-161)."""
        acp = state.alphas_cumprod.to(original_samples.device)
        acp = acp[timesteps.to(acp.device).long()]
        acp = acp.reshape(acp.shape + (1,) * (original_samples.ndim - acp.ndim))
        return acp ** 0.5 * original_samples + (1.0 - acp) ** 0.5 * noise

    def _alphas(self, state: DDIMState, timestep, device):
        """(alpha_cumprod at t, at the previous inference timestep), f32
        tensors of ``timestep``'s shape on ``device``: ``where(prev >= 0,
        acp[clip(prev, 0)], final)``. ``timestep`` is an int or a 0-dim
        integer tensor; a tensor on the card stays there."""
        acp = state.alphas_cumprod.to(device)
        t = torch.as_tensor(timestep, device=device).long()
        prev = t - self.num_train_timesteps // state.num_inference_steps
        a_prev = torch.where(prev >= 0, torch.take(acp, prev.clamp(min=0)),
                             float(state.final_alpha_cumprod))
        return torch.take(acp, t), a_prev

    def step(self, state: DDIMState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor) -> torch.Tensor:
        """One DDIM update x_t -> x_{t-1} (diffusers DDIMScheduler.step, eta 0)."""
        a_t, a_prev = self._alphas(state, timestep, sample.device)
        pred_x0 = (sample - (1.0 - a_t) ** 0.5 * model_output) / a_t ** 0.5
        if self.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
        pred_dir = (1.0 - a_prev) ** 0.5 * model_output
        return a_prev ** 0.5 * pred_x0 + pred_dir

    def renoise(self, state: DDIMState, sample: torch.Tensor, timestep,
                noise: torch.Tensor) -> torch.Tensor:
        """x_{t-1} back to x_t for multistep recurrent denoising:
        x * sqrt(a_t / a_{t-1}) + sqrt(1 - a_t / a_{t-1}) * noise
        (pipeline_animation_epi_advanced.py:700-705)."""
        a_t, a_prev = self._alphas(state, timestep, sample.device)
        ratio = a_t / a_prev
        return ratio ** 0.5 * sample + (1.0 - ratio) ** 0.5 * noise

"""A whole 2-view request, as the released CVD sampler defines it: the
prompt and the negative prompt through CLIP, the pose pair through the pose
encoder, DDIM (eta 0, "leading" spacing, steps offset 1) over the 4-row
classifier-free-guidance batch [uncond view 0, cond view 0, uncond view 1,
cond view 1], the epipolar cross-view attention pairing the views, and a
VAE decode of every frame. float32; the first frames' epipolar slopes are
drawn at each epi attention from the request's generator."""
from __future__ import annotations

import numpy as np
import torch

from .model import EpiCond

VAE_SCALE = 0.18215


def alphas_cumprod(sched: dict) -> torch.Tensor:
    n = sched["num_train_timesteps"]
    if sched["beta_schedule"] == "linear":
        betas = np.linspace(sched["beta_start"], sched["beta_end"], n, dtype=np.float64)
    else:
        betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))


def ddim_timesteps(sched: dict, steps: int) -> np.ndarray:
    ratio = sched["num_train_timesteps"] // steps
    return (np.arange(steps) * ratio).round()[::-1].astype(np.int64) + sched["steps_offset"]


def cfg4(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:1], x[:1], x[1:], x[1:]])


def decode(mods, latents: torch.Tensor, frames_per_call: int = 32) -> torch.Tensor:
    """[V, F, h, w, 4] latents -> [V, F, H, W, 3] in [0, 1]."""
    V, Fr = latents.shape[:2]
    z = latents.reshape((V * Fr,) + latents.shape[2:]) / VAE_SCALE
    imgs = torch.cat([mods["vae"].decode(z[i:i + frames_per_call])
                      for i in range(0, z.shape[0], frames_per_call)])
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)
    return imgs.reshape((V, Fr) + imgs.shape[1:])


@torch.no_grad()
def request(mods, config: dict, prompt_ids, negative_ids, plucker, F_mats, latents,
            generator: torch.Generator, steps: int, guidance: float,
            decode_frames: int = 32) -> torch.Tensor:
    """-> videos [2, F, H, W, 3] float32 in [0, 1]. Inputs on the models'
    device: token ids [1, 77], Plucker [2, F, H, W, 6], F mats [2, F, 3, 3],
    initial latents [2, F, H/8, W/8, 4]."""
    device = latents.device
    uncond, cond = mods["clip"](negative_ids), mods["clip"](prompt_ids)
    text = torch.cat([uncond, cond, uncond, cond])
    pose = [cfg4(p) for p in mods["pose_encoder"](plucker.float())]
    Fr = plucker.shape[1]
    F4 = cfg4(F_mats.float()).reshape(4 * Fr, 3, 3)
    sched = config["scheduler"]
    acp = alphas_cumprod(sched).to(device)
    ratio = sched["num_train_timesteps"] // steps
    x = latents.float()
    for t in ddim_timesteps(sched, steps).tolist():
        tt = torch.full((4,), t, dtype=torch.long, device=device)
        eps = mods["unet"](cfg4(x), tt, text, pose,
                           EpiCond(F4, Fr, config["epi_F_mat_size"], generator=generator))
        e = eps[[0, 2]] + guidance * (eps[[1, 3]] - eps[[0, 2]])
        a_t = acp[t]
        a_prev = acp[t - ratio] if t - ratio >= 0 else torch.ones((), device=device)
        x0 = (x - (1 - a_t) ** 0.5 * e) / a_t ** 0.5
        x = a_prev ** 0.5 * x0 + (1 - a_prev) ** 0.5 * e
    return decode(mods, x, decode_frames)

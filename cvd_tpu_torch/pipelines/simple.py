"""Simple 2-view pipeline (port of ``cvd_tpu/pipelines/simple.py``):

* 4-row CFG batch [uncond-src, cond-src, uncond-tgt, cond-tgt]
  (simple.py:131-149, 178-202);
* pose features computed once, outside the loop;
* the denoising as one timestep body (``_timestep_body``: the UNet calls of
  the multidiff windows, the guidance and the DDIM update), which on a
  CUDA device is captured once per shape as a CUDA graph and replayed for
  every timestep of every request (``pipelines/program.py``; the
  counterpart of the JAX package's jitted scan), and runs eagerly on the
  CPU, with ``capture=False``, with PAB or on a mesh;
* multidiff sliding windows: a video longer than the model's window is
  denoised as ``multidiff_total_steps`` overlapping windows per step, their
  noise predictions averaged where they overlap (simple.py:151-217);
* Pyramid Attention Broadcast (``pipelines/pab.py``), not with multidiff;
* SDXL's added conditioning where the UNet takes it (``text_time``): the
  pooled text of the 4 CFG rows and their time ids, inputs of every UNet
  call;
* the UNet call's sublayers timed by kind (``utils/tracing.IntervalTimer``,
  passed to the UNet call; kept by the captured graph) and recorded as
  device spans where tracing is on;
* a whole-video VAE decode;
* sharded sampling over a ("rows", "frames") mesh (``parallel/mesh.py``,
  SPMD over ``torchrun``'s processes): every rank encodes the text and the
  poses, draws the latents and takes the DDIM steps alike; each UNet call
  runs on this rank's block of the 4 CFG rows and the window's frames, and
  its noise prediction is all-gathered before the guidance.

The request's path and the preparation the two samplers share are
``pipelines/common.Sampler``'s. More than two views: ``pipelines/advanced.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.parallel.mesh import constrain, gather
from cvd_tpu_torch.parallel.shard_ops import check_divides, local_rows
from cvd_tpu_torch.pipelines.common import Sampler
from cvd_tpu_torch.pipelines.program import chunks
from cvd_tpu_torch.schedulers.ddim import DDIMScheduler


def _cfg4(x: torch.Tensor) -> torch.Tensor:
    """[2, ...] (src, tgt) -> [4, ...] chunk-ordered [src, src, tgt, tgt]."""
    return torch.cat([x[:1], x[:1], x[1:], x[1:]], dim=0)


class SimplePipeline(Sampler):
    """2-view, fixed-pair generation with epipolar sync. On a ``mesh`` the
    rows must divide 4 and the frames the window."""

    @torch.no_grad()
    def __call__(
        self,
        prompt_ids: torch.Tensor,    # [1, 77] int
        negative_ids: torch.Tensor,  # [1, 77] int
        plucker: torch.Tensor,       # [2, F, H, W, 6]
        F_mats: torch.Tensor,        # [2, F, 3, 3] folded pair mats (video-major)
        num_inference_steps: int = 25,
        guidance_scale: float = 8.5,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        decode: bool = True,
        multidiff_total_steps: int = 1,
        multidiff_overlaps: int = 12,
        pab_config=None,
    ) -> torch.Tensor:
        """Returns images [2, F, H, W, 3] in [0, 1] (or the final latents
        [2, F, H/8, W/8, 4] with ``decode=False``), f32.

        With ``multidiff_total_steps`` > 1 the F frames are denoised as that
        many windows, each overlapping the next by ``multidiff_overlaps``
        frames: F = steps * (window - overlap) + overlap. The pose encoder
        sees all F frames, so F is bounded by its temporal positional
        encoding, as in the JAX package. ``pab_config``: a ``PABConfig``
        (not with multidiff)."""
        m = self.m
        V, Fr, H, W, _ = plucker.shape
        if V != 2:
            raise ValueError("SimplePipeline is the fixed 2-view sampler")
        windows = multidiff_total_steps
        Fw = Fr if windows == 1 else (Fr - multidiff_overlaps) // windows + multidiff_overlaps
        stride = Fw - multidiff_overlaps
        if windows != 1 and (stride <= 0 or (windows - 1) * stride + Fw != Fr):
            raise ValueError(f"{Fr} frames are not {windows} windows of {Fw} frames "
                             f"overlapping by {multidiff_overlaps}: frames must equal "
                             "steps * (window - overlap) + overlap")
        max_frames = m.pose_encoder.temporal_pe_max_len
        if Fr > max_frames:
            raise ValueError(f"{Fr} frames: the pose encoder runs on every frame of the video "
                             f"and its temporal positional encoding holds {max_frames}")
        if pab_config is not None and windows != 1:
            raise ValueError("PAB + multidiff windows is unsupported")
        mesh = self.mesh
        if mesh is not None:
            if pab_config is not None:
                raise ValueError("--pab + --sharded is not validated; pick one")
            check_divides(mesh, 4, Fw, "SimplePipeline")
        settings = _Settings(m.scheduler, num_inference_steps, float(guidance_scale),
                             windows, Fw, stride)
        return self._request(
            "SimplePipeline", settings, chunks([1] * num_inference_steps),
            lambda state: self._prepare(prompt_ids, negative_ids, plucker, F_mats, state,
                                        generator, latents, Fw, stride, windows),
            generator, pab_config, decode)

    def _prepare(self, prompt_ids, negative_ids, plucker, F_mats, state, generator, latents,
                 Fw, stride, windows) -> dict:
        """Everything before the denoising loop (the JAX package's ``_run``
        up to its scan): ``_prepare_rows``, the folded F mats of the 4 CFG
        rows in chunk order [src, src, tgt, tgt] and the overlap weights, as
        the tensors the timestep body reads."""
        device = self.program.device
        Fr = plucker.shape[1]
        inputs = self._prepare_rows(prompt_ids, negative_ids, plucker, state, generator, latents)
        inputs["F4"] = _cfg4(F_mats.to(device=device, dtype=torch.float32))   # [4, F, 3, 3]
        # the overlap-average weights: 1 / the number of windows over each frame
        counts = torch.zeros(Fr, device=device)
        for w in range(windows):
            counts[w * stride:w * stride + Fw] += 1.0
        inputs["inv_counts"] = (1.0 / counts)[None, :, None, None, None]
        return inputs

    def _timestep_body(self, bufs, ts, start, repeats, generator, timer, s: "_Settings",
                       pab) -> int:
        """The timesteps ``ts`` ([k] int64 on the device; ``start``: the
        first one's index): for each, the UNet call of every window, the
        guidance, the overlap average and the DDIM update (the JAX package's
        scan ``step``, simple.py:206-216). Reads only ``bufs`` and writes
        the latents back into ``bufs["latents"]``. -> the UNet calls made."""
        m, mesh = self.m, self.mesh
        state = dataclasses.replace(m.scheduler.set_timesteps(s.steps),
                                    alphas_cumprod=bufs["acp"])
        pose_feats = [bufs[k] for k in sorted(bufs) if k.startswith("pose")]
        text, F4 = bufs["text"], bufs["F4"]

        def window_cond(start: int):
            """The pose features and epipolar conditioning of the window of
            frames [start, start + Fw)."""
            Fw = s.window
            return [constrain(p[:, start:start + Fw], mesh, "rows", "frames")
                    for p in pose_feats], EpiConditioning(
                F_mats=local_rows(F4[:, start:start + Fw].reshape(4 * Fw, 3, 3), mesh, Fw),
                video_length=Fw, F_mat_size=self.F_mat_size, rand_slope_ff=self.rand_slope_ff,
                generator=generator, mesh=mesh)

        starts = [w * s.stride for w in range(s.windows)]
        conds = [window_cond(w) for w in starts]
        added = ({"text_embeds": constrain(bufs["add_text"], mesh, "rows"),
                  "time_ids": constrain(bufs["add_time"], mesh, "rows")}
                 if "add_text" in bufs else None)
        latents, calls = bufs["latents"], 0
        for j in range(len(repeats)):
            t = ts[j]
            if pab is not None:
                pab.at_step(start + j)
            eps_full = torch.zeros_like(latents)
            for w, (pf, epi_cond) in zip(starts, conds):
                with timer:
                    lat_in = constrain(_cfg4(latents[:, w:w + s.window]), mesh, "rows", "frames")
                    eps = m.unet(lat_in, t, constrain(text, mesh, "rows"), pf, epi_cond,
                                 pab=pab, mesh=mesh, added_cond=added, timer=self.sublayers)
                    eps = gather(eps, mesh, "rows", "frames").float()
                calls += 1
                # chunk(4): uncond rows (0, 2), cond rows (1, 3)
                eps_u = torch.stack([eps[0], eps[2]])
                eps_t = torch.stack([eps[1], eps[3]])
                eps_full[:, w:w + s.window] += eps_u + s.guidance_scale * (eps_t - eps_u)
            latents = m.scheduler.step(state, eps_full * bufs["inv_counts"], t, latents)
        bufs["latents"].copy_(latents)
        return calls


@dataclasses.dataclass(frozen=True)
class _Settings:
    """What the 2-view timestep body depends on besides its tensors."""

    scheduler: DDIMScheduler
    steps: int
    guidance_scale: float
    windows: int
    window: int
    stride: int

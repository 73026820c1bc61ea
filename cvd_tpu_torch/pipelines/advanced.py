"""Advanced N-view pipeline (port of ``cvd_tpu/pipelines/advanced.py``, the
reference's ``pipeline_animation_epi_advanced.py``):

* interleaved CFG rows [v0-uncond, v0-cond, v1-uncond, ...]
  (``repeat_interleave(2)``), recombined by [0::2] / [1::2] (:672-691);
* a random perfect matching of the views at every UNet call; ``kv_index``
  routes each row to its partner's row, and the fundamental matrices of
  the sampled pairs are computed on the device (:621-647);
* multistep recurrent denoising: every timestep but the last is taken
  ``multistep`` times, re-noised in between (:601-705);
* ``accumulate_step`` pairings averaged into one noise prediction (:605,
  :699), as a loop of UNet calls or, with ``accumulate_batched``, as ONE
  call at batch 2V * accumulate_step with each group's routing offset into
  its own row block;
* the fixed 2-view path (``F_mats``) and the homography path (``H_mats``);
* Pyramid Attention Broadcast (``pipelines/pab.py``): the reuse flags
  follow the timestep, so every multistep repeat and every pairing of a
  timestep shares them, and the one cache of the request carries across
  all its UNet calls (advanced.py:401-480);
* sharded sampling over a ("rows", "frames") mesh (``parallel/mesh.py``,
  SPMD over ``torchrun``'s processes): every rank draws the same pairings
  and noise from its generator (seeded alike) and takes the steps alike;
  each UNet call runs on this rank's block of the 2V (or 2V * A) CFG rows
  and of the frames, with the global routing remapped inside
  ``parallel/shard_ops.py``, and its noise prediction is all-gathered.

The denoising is one body over a chunk of timesteps (``_timestep_body``,
cvd_tpu's ``_sampling_scan`` body :265-485): on a CUDA device it is
captured as a CUDA graph once per shape and replayed for every chunk of
every request (``pipelines/program.py``), with ``step_chunk`` timesteps a
graph (one without), as cvd_tpu's chunk program (:87-124, ``_call_chunked``
:203-263); it runs eagerly on the CPU, with ``capture=False``, with PAB or
on a mesh. Every random draw (initial latents, pairings, re-noise, epi
slopes) comes from the one ``generator`` the caller passes; a captured
request draws the numbers the eager one draws. The request's path and the
preparation the two samplers share are ``pipelines/common.Sampler``'s; a
UNet with added conditioning (SDXL's ``text_time``) is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cvd_tpu_torch.geometry.epipolar import fundamental_between_views_torch
from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.parallel.mesh import constrain, gather
from cvd_tpu_torch.parallel.shard_ops import check_divides, local_rows
from cvd_tpu_torch.pipelines.common import PipelineModules, Sampler, interleave_cfg
from cvd_tpu_torch.pipelines.program import chunks
from cvd_tpu_torch.schedulers.ddim import DDIMScheduler


def random_pairing(generator: Optional[torch.Generator], num_views: int) -> torch.Tensor:
    """partner[v] of a random perfect matching of the views (:625-629),
    int64 [num_views] on the generator's device."""
    device = generator.device if generator is not None else "cpu"
    perm = torch.randperm(num_views, generator=generator, device=device)
    a, b = perm[:num_views // 2], perm[num_views // 2:]
    partner = torch.empty_like(perm)
    partner[a] = b
    partner[b] = a
    return partner


def partner_rows(partner: torch.Tensor, num_frames: int) -> torch.Tensor:
    """The routing of a pairing over the interleaved CFG rows: partner [V] ->
    kv_index [2 * V * F], where row r of view v reads the row of the same CFG
    half and frame of view partner[v]: r + (partner[v] - v) * 2F."""
    two_f = 2 * num_frames
    row = torch.arange(partner.shape[0] * two_f, device=partner.device)
    row_v = row // two_f
    return row + (partner[row_v] - row_v) * two_f


class AdvancedPipeline(Sampler):
    """N-view generation with a fresh pairing of views at every UNet call. On
    a ``mesh`` the rows must divide 2V (2V * A batched) and the frames F."""

    def __init__(self, modules: PipelineModules, F_mat_size: int = 256,
                 rand_slope_ff: bool = True, fix_firstframe: bool = False,
                 accumulate_batched: bool = False, mesh=None, capture: bool = True):
        super().__init__(modules, F_mat_size, rand_slope_ff, mesh, capture)
        self.fix_firstframe = fix_firstframe
        self.accumulate_batched = accumulate_batched

    # the draw between UNet calls besides ``draw_noise``, apart so that a
    # test can replay another program's pairings

    def draw_pairing(self, generator: Optional[torch.Generator], num_views: int) -> torch.Tensor:
        return random_pairing(generator, num_views)

    @torch.no_grad()
    def __call__(
        self,
        prompt_ids: torch.Tensor,                # [1, 77] int
        negative_ids: torch.Tensor,              # [1, 77] int
        plucker: torch.Tensor,                   # [V, F, H, W, 6]
        c2w: Optional[torch.Tensor] = None,      # [V*F, 4, 4] camera poses (N-view path)
        K_mats: Optional[torch.Tensor] = None,   # [V*F, 3, 3]
        F_mats: Optional[torch.Tensor] = None,   # [2, F, 3, 3] fixed pair mats (V == 2)
        H_mats: Optional[torch.Tensor] = None,   # [V, F, 3, 3] homographies (pose-free)
        num_inference_steps: int = 25,
        guidance_scale: float = 8.5,
        multistep: int = 1,
        accumulate_step: int = 1,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        decode: bool = True,
        pab_config=None,
        step_chunk: Optional[int] = None,
    ) -> torch.Tensor:
        """Returns images [V, F, H, W, 3] in [0, 1] (or the final latents
        [V, F, H/8, W/8, 4] with ``decode=False``), f32. ``pab_config``: a
        ``PABConfig``. ``step_chunk``: the timesteps a CUDA graph holds (1
        without; the last timestep of a multistep run, taken once, and a
        ragged last chunk are graphs of their own); the latents are those
        of any other chunk length."""
        m = self.m
        V, Fr = plucker.shape[:2]
        A = accumulate_step
        if m.unet.config.addition_embed_type:
            raise ValueError(f"a UNet with addition_embed_type "
                             f"{m.unet.config.addition_embed_type!r} (SDXL): the N-view sampler "
                             "does not pass added conditioning yet (ROADMAP queue 5, item 1)")
        n_view_path = H_mats is None and not (V == 2 and F_mats is not None)
        if n_view_path and (c2w is None or K_mats is None):
            raise ValueError("the N-view path needs c2w and K_mats (or pass F_mats for "
                             "2 views, or H_mats)")
        if n_view_path and V % 2:
            raise ValueError(f"{V} views: the pairing is a perfect matching, so the "
                             "number of views must be even")
        batched = self.accumulate_batched and A > 1 and n_view_path
        groups = A if batched else 1
        mesh = self.mesh
        if mesh is not None:
            if pab_config is not None:
                raise ValueError("--pab + --sharded is not validated; pick one")
            check_divides(mesh, 2 * V * groups, Fr, "AdvancedPipeline")
        last = num_inference_steps - 1
        # the last timestep is taken once (:602)
        plan = chunks([1 if i == last else multistep for i in range(last + 1)], step_chunk)
        settings = _Settings(m.scheduler, num_inference_steps, float(guidance_scale), V, A,
                             groups, "h" if H_mats is not None else "n" if n_view_path else "f")
        return self._request(
            "AdvancedPipeline", settings, plan,
            lambda state: self._prepare(prompt_ids, negative_ids, plucker, c2w, K_mats, F_mats,
                                        H_mats, state, generator, latents, groups, n_view_path),
            generator, pab_config, decode)

    def _prepare(self, prompt_ids, negative_ids, plucker, c2w, K_mats, F_mats, H_mats, state,
                 generator, latents, groups, n_view_path) -> dict:
        """``_prepare_rows`` and the per-row mats (cvd_tpu's ``_prepare``,
        advanced.py:150), as the tensors the timestep body reads."""
        device = self.program.device
        V, Fr = plucker.shape[:2]
        inputs = self._prepare_rows(prompt_ids, negative_ids, plucker, state, generator, latents,
                                    groups)
        # the (view, frame) of every interleaved CFG row in the [V * F] camera arrays
        row = torch.arange(2 * V * Fr, device=device)
        src = (row // (2 * Fr)) * Fr + row % Fr
        if H_mats is not None:
            rows = H_mats.to(device=device, dtype=torch.float32).reshape(V * Fr, 3, 3)
            inputs["H_rows"] = rows[src]
        elif not n_view_path:
            rows = F_mats.to(device=device, dtype=torch.float32).reshape(V * Fr, 3, 3)
            inputs["F_rows"] = rows[src]
        else:
            inputs["c2w"] = c2w.to(device=device, dtype=torch.float32)
            inputs["K_mats"] = K_mats.to(device=device, dtype=torch.float32)
        return inputs

    def _timestep_body(self, bufs, ts, start, repeats, generator, timer, s: "_Settings",
                       pab) -> int:
        """The timesteps ``ts`` ([k] int64 on the device; ``start``: the
        first one's index), timestep j taken ``repeats[j]`` times: each time
        ``accumulate_step`` pairings (a loop of UNet calls, or one call of
        ``groups`` of them), guidance, the DDIM step and, between repeats,
        the re-noise (cvd_tpu's ``timestep_body`` / ``mt_body``). Reads only
        ``bufs`` and writes the latents back into ``bufs["latents"]``.
        -> the UNet calls made."""
        m, mesh = self.m, self.mesh
        device = bufs["latents"].device
        state = dataclasses.replace(m.scheduler.set_timesteps(s.steps),
                                    alphas_cumprod=bufs["acp"])
        V, groups = s.views, s.groups
        Fr = bufs["latents"].shape[1]
        text = constrain(bufs["text"], mesh, "rows")
        pose_feats = [constrain(bufs[k], mesh, "rows", "frames")
                      for k in sorted(bufs) if k.startswith("pose")]
        n_rows = 2 * V * Fr
        row = torch.arange(n_rows, device=device)
        row_v, row_f = row // (2 * Fr), row % Fr

        def conditioning(F_mats=None, H_mats=None, kv_index=None) -> EpiConditioning:
            """The conditioning of the global (b f) rows' mats, this rank's
            rows of them on a mesh."""
            return EpiConditioning(
                F_mats=None if F_mats is None else local_rows(F_mats, mesh, Fr),
                H_mats=None if H_mats is None else local_rows(H_mats, mesh, Fr),
                kv_index=kv_index, video_length=Fr, F_mat_size=self.F_mat_size,
                rand_slope_ff=self.rand_slope_ff, fix_firstframe=self.fix_firstframe,
                cfg_factor=2, generator=generator, mesh=mesh)

        # the conditioning of the two paths that draw no pairing
        fixed = (conditioning(H_mats=bufs["H_rows"]) if s.path == "h" else
                 conditioning(F_mats=bufs["F_rows"]) if s.path == "f" else None)

        def pairing():
            """A fresh pairing: its fundamental matrices and routing."""
            c2w, K_mats = bufs["c2w"], bufs["K_mats"]
            partner = self.draw_pairing(generator, V).to(device)
            src = row_v * Fr + row_f
            dst = partner[row_v] * Fr + row_f
            return (fundamental_between_views_torch(c2w[src], c2w[dst], K_mats[src], K_mats[dst]),
                    partner_rows(partner, Fr))

        calls = 0

        def guided_eps(lat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            """The guided noise prediction of ``groups`` pairings in one UNet
            call, summed over the groups."""
            nonlocal calls
            cond_t = fixed
            if fixed is None:
                pairs = [pairing() for _ in range(groups)]
                cond_t = conditioning(
                    F_mats=torch.cat([f for f, _ in pairs]),
                    kv_index=torch.cat([k + g * n_rows for g, (_, k) in enumerate(pairs)]))
            lat_in = constrain(interleave_cfg(lat).repeat(groups, 1, 1, 1, 1), mesh,
                               "rows", "frames")
            with timer:
                eps = m.unet(lat_in, t, text, pose_feats, cond_t, pab=pab, mesh=mesh)
                eps = gather(eps, mesh, "rows", "frames").float()
            calls += 1
            eps = eps.reshape((groups, 2 * V) + eps.shape[1:])
            guided = eps[:, 0::2] + s.guidance_scale * (eps[:, 1::2] - eps[:, 0::2])
            return guided.sum(0)

        latents = bufs["latents"]
        for j, reps in enumerate(repeats):
            t = ts[j]
            if pab is not None:
                pab.at_step(start + j)
            for rep in range(reps):
                eps = guided_eps(latents, t)
                for _ in range(s.accumulate_step // groups - 1):
                    eps = eps + guided_eps(latents, t)
                latents = m.scheduler.step(state, eps / s.accumulate_step, t, latents)
                if rep != reps - 1:
                    noise = self.draw_noise(generator, latents.shape).to(device)
                    latents = m.scheduler.renoise(state, latents, t, noise)
        bufs["latents"].copy_(latents)
        return calls


@dataclasses.dataclass(frozen=True)
class _Settings:
    """What the N-view timestep body depends on besides its tensors."""

    scheduler: DDIMScheduler
    steps: int
    guidance_scale: float
    views: int
    accumulate_step: int
    groups: int
    path: str          # "n": pairings of c2w / K_mats, "f": fixed F_mats, "h": H_mats

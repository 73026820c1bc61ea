"""Entry kind ``sample_pair``: 2-view requests through the program's
``SimplePipeline``, built as its 2-view CLI builds it (captured program,
the run's own generator, the initial latents handed in), closed loop, one
client. A request is a prompt and a pair of pose files in (the program's
``ValRealEstate10KPoseFolded`` makes the Plucker rays and F matrices) and
both views' frames decoded to uint8 on the host out.

Set-up: the seeded weights, the pipeline, and the cell's warm-up requests
(the first one captures the timestep graph). The window runs whole
requests until ``--seconds`` have passed; ``request_s`` is its time over
its requests. With ``--trace 1`` the profiler covers the mix's traced
requests. Then the check: one request of the window, drawn from the seed,
against the float32 reference given the same inputs and the same draws.
"""
from __future__ import annotations

import os
import random
import time

import numpy as np

from port_bench.lib import names, port, runtime
from port_bench.lib.context import Context, Record, check, mean
from port_bench.lib.trace import Tracer, span
from port_bench.traffic import generate


def _pose_files(ctx: Context, spec: dict) -> list:
    d = os.path.join(ctx.work_dir, "poses")
    os.makedirs(d, exist_ok=True)
    paths = []
    for v, text in enumerate(spec["poses"]):
        paths.append(os.path.join(d, f"view{v}.txt"))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths


def _latents(ctx: Context, spec: dict):
    import torch

    mix, S = ctx.mix, ctx.mix["size"]
    g = torch.Generator(device=ctx.device).manual_seed(spec["latents_seed"])
    return torch.randn((2, mix["frames"], S // 8, S // 8, 4), generator=g, device=ctx.device)


class Requests:
    """The program's side: the pipeline and one request at a time."""

    def __init__(self, ctx: Context, modules):
        from cvd_tpu_torch.pipelines.simple import SimplePipeline

        self.ctx = ctx
        self.captions = generate.captions(ctx.mix)
        self.pipe = SimplePipeline(modules, F_mat_size=ctx.config["epi_F_mat_size"],
                                   rand_slope_ff=True, capture=True)

    def spec(self, i: int) -> dict:
        return generate.request(self.ctx.mix, self.ctx.stream("request", i), self.captions)

    def __call__(self, i: int):
        """-> (uint8 videos [2, F, H, W, 3], seconds, UNet ms of each call)."""
        import torch
        from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded

        ctx, mix = self.ctx, self.ctx.mix
        F, S = mix["frames"], mix["size"]
        t0 = time.perf_counter()
        with span("prep"):
            spec = self.spec(i)
            p0, p1 = _pose_files(ctx, spec)
            sample = ValRealEstate10KPoseFolded(
                validation_prompts=[spec["prompt"]], validation_negative_prompts=[spec["negative"]],
                pose_file_0=p0, pose_file_1=p1, sample_n_frames=F, sample_size=S)[0]
            ids = torch.from_numpy(generate.tokenize([spec["prompt"]]))
            neg = torch.from_numpy(generate.tokenize([spec["negative"]]))
            plucker = torch.from_numpy(sample["plucker_embedding"]).float().reshape(2, F, S, S, 6)
            F_mats = torch.from_numpy(sample["F_mats"]).float().reshape(2, F, 3, 3)
            latents = _latents(ctx, spec)
            gen = torch.Generator(device=ctx.device).manual_seed(spec["generator_seed"])
        with span("pipeline"):
            videos = self.pipe(ids, neg, plucker, F_mats, num_inference_steps=mix["steps"],
                               guidance_scale=mix["guidance"], generator=gen, latents=latents)
        with span("to_host"):
            out = runtime.to_uint8(videos.cpu().numpy())
        return out, time.perf_counter() - t0, list(self.pipe.unet_step_ms)


def reference_video(ctx: Context, spec: dict, precision: str = "f32") -> np.ndarray:
    """The reference's uint8 videos of request ``spec``, on the run's device
    (the program's state freed before)."""
    import torch

    from port_bench.reference import geometry, ops

    mix, S, dev = ctx.mix, ctx.mix["size"], ctx.device
    p0, p1 = _pose_files(ctx, spec)
    plucker, F_mats = geometry.pair_conditioning(p0, p1, mix["frames"], S)
    arch = names.architecture(ctx.config["architecture"])
    mods = port.reference_modules(ctx.config, ctx.seed, dev)
    try:
        with runtime.exact_float32(), ops.precision(precision):
            video = arch.reference_request(
                mods, ctx.config,
                torch.from_numpy(generate.tokenize([spec["prompt"]])).to(dev),
                torch.from_numpy(generate.tokenize([spec["negative"]])).to(dev),
                torch.from_numpy(plucker).to(dev), torch.from_numpy(F_mats).to(dev),
                _latents(ctx, spec), torch.Generator(device=dev).manual_seed(
                    spec["generator_seed"]), mix["steps"], mix["guidance"])
        return runtime.to_uint8(video.cpu().numpy())
    finally:
        del mods
        runtime.free(dev)


def run(ctx: Context) -> Record:
    rec = Record()
    dev = ctx.device
    t = time.perf_counter()
    modules = port.build_modules(ctx.config, ctx.seed, dev)
    runtime.sync(dev)
    rec.readings["build_s"] = time.perf_counter() - t
    requests = Requests(ctx, modules)
    capture_s = 0.0
    for w in range(ctx.cell["run"]["warmup_requests"]):
        requests(-1 - w)
        capture_s += requests.pipe.program.stats["capture_s"]
    rec.readings["capture_s"] = capture_s
    runtime.sync(dev)

    run_cfg = ctx.cell["run"]
    skip, traced = run_cfg["trace_skip"], run_cfg["traced_requests"]
    tracer = Tracer(ctx.trace, ctx.work_dir, dev)
    outputs, seconds, unet_ms = [], [], []
    t_win = time.perf_counter()
    rec.e2e["setup_s"] = t_win - ctx.t_start
    i = 0
    while True:
        if i == skip:
            tracer.start()
        rec.attempted += 1
        try:
            with span("request"):
                out, s, ms = requests(i)
            outputs.append(out)
            seconds.append(s)
            unet_ms.append(ms)
        except Exception:  # noqa: BLE001 - a failed request is counted and reported
            import traceback

            traceback.print_exc()
            rec.failed += 1
            outputs.append(None)
        i += 1
        if i == skip + traced:
            tracer.stop()
            rec.traced_units = traced
        if time.perf_counter() - t_win >= ctx.seconds:
            break
    t_end = time.perf_counter()
    tracer.stop()
    rec.traced_units = rec.traced_units or max(0, i - skip)
    rec.trace = tracer.summary
    rec.e2e["request_s"] = (t_end - t_win) / i
    rec.peak_bytes = runtime.peak_bytes(dev)
    rec.readings["unet_call_ms"] = mean([x for ms in unet_ms for x in ms])
    rec.readings["outside_unet_ms"] = mean([1e3 * s - sum(ms) for s, ms in zip(seconds, unet_ms)])

    k = random.Random(ctx.stream("check")).randrange(i)
    program_video, spec = outputs[k], requests.spec(k)
    del requests, modules, outputs
    runtime.free(dev)
    limit = ctx.cell["limits"]["frame_rmse_max"]
    if program_video is None:
        rec.checks["frame_rmse_max"] = check(float("inf"), limit)
    else:
        rec.checks["frame_rmse_max"] = check(
            runtime.frame_rmse_max(program_video, reference_video(ctx, spec)), limit)
    return rec


def calibrate(ctx: Context, control: bool = True) -> dict:
    """The check's readings on the run's seed, with no window: the program's
    first request after the warm-up against the reference, and (``control``)
    the float8 reference in the program's place."""
    modules = port.build_modules(ctx.config, ctx.seed, ctx.device)
    requests = Requests(ctx, modules)
    for w in range(ctx.cell["run"]["warmup_requests"]):
        requests(-1 - w)
    program_video, _, _ = requests(0)
    spec = requests.spec(0)
    del requests, modules
    runtime.free(ctx.device)
    ref = reference_video(ctx, spec)
    out = {"seed": ctx.seed, "frame_rmse_max": runtime.frame_rmse_max(program_video, ref)}
    if control:
        out["control.frame_rmse_max"] = runtime.frame_rmse_max(
            reference_video(ctx, spec, "fp8"), ref)
    return out

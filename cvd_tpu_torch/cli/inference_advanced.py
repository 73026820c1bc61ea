"""N-view inference CLI (port of ``cvd_tpu/cli/inference_advanced.py``, the
reference's ``inference_epi_advanced.py``).

    python -m cvd_tpu_torch.cli.inference_advanced --random-weights-full --bf16 \
        --view_num 4 --cam_pattern circle --multistep 3 --accumulate_step 2 \
        --caption_file assets/example_prompts.json --use_negative_prompt \
        --out_root results/

The weight options are ``cli/inference.py``'s (``--ori_model_path`` and the
motion, epi and pose-adaptor checkpoints, or ``--random-weights[-full]``).
Procedural camera patterns (circle / upper_hemi / interpolate), multistep
recurrent denoising, accumulate-step pair averaging. Each (seed, prompt)
writes ``<out_root>/<seed_id>_<idx>/videos.npy`` (uint8 [V, F, H, W, 3]) and
a NeRF-style ``transforms.json`` (OpenCV -> OpenGL axes, reference
:362-410) and, where ``imageio`` is installed, ``video.mp4`` / ``video.gif``
(the views stacked) and ``images/<view>/%04d.png``. ``--pab
[--pab_ranges ...]`` turns on Pyramid Attention Broadcast. The run log is
``<out_root>/log_p0.txt``. ``--scan_layers`` is taken and does nothing.
``--step_chunk k`` puts k timesteps in each replayed CUDA graph: the same
videos as without it.

``--sharded`` samples over a ("rows", "frames") mesh of the processes that
``torchrun`` starts, as ``cli/inference.py`` does: the 2V CFG rows (2V *
accumulate_step with ``accumulate_batched``) over rows = gcd(4, world), the
frames over world / rows; rank 0 alone decodes, logs and writes. Not with
``--pab``; the mesh must divide the rows and the frames.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List

import numpy as np
import torch


def build_cameras(args):
    """-> (c2w [V*F, 4, 4], K [V*F, 3, 3]) of ``--cam_pattern``; the
    ``--cam_perturb_traj`` perturbation is drawn from a generator seeded with 0."""
    from cvd_tpu_torch.geometry.trajectories import (
        circle_trajectory, default_intrinsics, interpolate_trajectories, upper_hemi_trajectory,
    )

    fn = {"circle": circle_trajectory, "upper_hemi": upper_hemi_trajectory,
          "interpolate": interpolate_trajectories}[args.cam_pattern]
    c2ws = fn(args.view_num, args.video_length, args.camera_dist, args.cam_perturb_traj,
              np.random.default_rng(0))
    K = default_intrinsics(args.view_num, args.video_length, args.image_height,
                           args.image_width)
    return c2ws, K


def export_transforms_json(path, intrinsics, frames, args) -> None:
    """NeRF-style transforms.json; ``frames`` = (file path, OpenCV c2w) pairs,
    written with the y and z axes flipped (OpenGL), reference :362-410."""
    data = {
        "fl_x": float(intrinsics[0, 0]),
        "fl_y": float(intrinsics[0, 1]),
        "cx": float(intrinsics[0, 2]),
        "cy": float(intrinsics[0, 3]),
        "w": args.image_width,
        "h": args.image_height,
        "camera_model": "PINHOLE",
        "frames": [],
    }
    for file_path, c2w in frames:
        c2w = np.array(c2w, np.float64).copy()
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        data["frames"].append({"file_path": file_path, "transform_matrix": c2w.tolist()})
    with open(path, "w") as f:
        json.dump(data, f, indent=4)


def _refuse(args) -> None:
    """What cannot run, before anything is built or written."""
    if args.image_width != args.image_height:
        raise SystemExit(f"--image_width {args.image_width} != --image_height "
                         f"{args.image_height}: the epipolar attention assumes a square "
                         "token grid; use a square resolution")
    if args.view_num % 2 != 0:
        raise SystemExit(f"--view_num {args.view_num} must be even: the pairing of views "
                         "at every step is a perfect matching")
    if args.mono_direction:
        # the reference rejects this path too (attention_processor.py:622)
        raise NotImplementedError("--mono_direction is not supported")
    if args.step_chunk is not None and args.step_chunk < 1:
        raise SystemExit(f"--step_chunk {args.step_chunk}: a chunk holds at least one timestep")
    if args.pab and args.sharded:
        raise SystemExit("--pab + --sharded is not validated; pick one")


def main(args, accumulate_batched: bool = False, tokenizer=None, widths=None,
         capture: bool = True) -> List[dict]:
    """Runs every (seed, prompt). Returns one record each: ``videos`` (f32
    [V, F, H, W, 3] in [0, 1]), ``seconds`` (wall time of the request),
    ``unet_step_ms`` (each UNet call), ``program`` (how the sampler ran it:
    ``SamplingProgram.stats``) and ``out`` (its directory).
    ``accumulate_batched``: the ``--accumulate_step`` pairings as one UNet
    call (``AdvancedPipeline``). ``capture``: ``AdvancedPipeline``'s (False:
    the timesteps run eagerly on the card too). ``tokenizer``: an object to
    tokenize with in place of the one the weights come with. ``widths``:
    ``build_modules``'s, for checkpoint files narrower than SD1.5's. With
    ``--sharded`` every rank returns the records, and only rank 0's hold the
    videos (the others' are None)."""
    from cvd_tpu_torch.cli.build import resolve_device
    from cvd_tpu_torch.parallel.mesh import inference_mesh, process_group
    from cvd_tpu_torch.parallel.shard_ops import check_divides
    from cvd_tpu_torch.pipelines.pab import PABConfig

    _refuse(args)
    pab_config = None
    if args.pab:
        pab_config = PABConfig.from_string(args.pab_ranges) if args.pab_ranges else PABConfig()
    run = (args, pab_config, accumulate_batched, tokenizer, widths, capture)
    if not args.sharded:
        return _requests(*run, resolve_device(args.device), None)
    with process_group(args.device, "--sharded",
                       "cvd_tpu_torch.cli.inference_advanced") as (_, world, device):
        mesh = inference_mesh(world)
        groups = args.accumulate_step if accumulate_batched and args.accumulate_step > 1 else 1
        check_divides(mesh, 2 * args.view_num * groups, args.video_length, "--sharded")
        return _requests(*run, device, mesh)


def _requests(args, pab_config, accumulate_batched, tokenizer, widths, capture, device,
              mesh) -> List[dict]:
    """``main``'s requests on ``device``, over ``mesh`` where one is given
    (rank 0 alone logs and writes, and holds the videos)."""
    from cvd_tpu_torch.cli.build import SD15_WIDTHS, build_modules
    from cvd_tpu_torch.cli.inference import load_prompts
    from cvd_tpu_torch.geometry.plucker import ray_condition
    from cvd_tpu_torch.parallel.mesh import replicate
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline
    from cvd_tpu_torch.utils.logging import setup_logger
    from cvd_tpu_torch.utils.video import (
        have_imageio, save_npy, save_video, save_video_as_images,
    )

    captions, negatives, seeds = load_prompts(args.caption_file, args.use_negative_prompt)
    lead = mesh is None or mesh.rank == 0
    V, F, S = args.view_num, args.video_length, args.image_height
    c2ws, K = build_cameras(args)
    intr = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], -1).astype(np.float32)
    plucker = torch.from_numpy(ray_condition(intr[None], c2ws[None].astype(np.float32), S, S)[0]
                               ).reshape(V, F, S, S, 6)
    c2w_t = torch.from_numpy(c2ws.astype(np.float32))
    K_t = torch.from_numpy(K.astype(np.float32))

    logger = setup_logger(args.out_root if lead else None,
                          name="cvd_tpu_torch.inference_advanced",
                          process_index=0 if lead else mesh.rank)
    if not have_imageio():
        logger.info("imageio is not installed: each request writes videos.npy and "
                    "transforms.json only, no video.{gif,mp4} and no images/<view>/*.png")
    t0 = time.perf_counter()
    modules, tokenizer = build_modules(args, device, tokenizer=tokenizer,
                                       widths=widths or SD15_WIDTHS)
    logger.info(f"[inference_advanced] built modules on {device} in "
                f"{time.perf_counter() - t0:.1f} s")
    if mesh is not None:
        for module in (modules.unet, modules.vae, modules.clip, modules.pose_encoder):
            replicate(module, mesh)
        logger.info(f"[inference_advanced] sharded sampling over mesh {mesh.shape}")
    pipe = AdvancedPipeline(modules, F_mat_size=S, rand_slope_ff=True,
                            fix_firstframe=args.fix_firstframe,
                            accumulate_batched=accumulate_batched, mesh=mesh,
                            capture=capture)
    results = []
    for seed_id in range(args.multiseed):
        for idx, prompt in enumerate(captions):
            seed = (seeds[idx] if (seeds and args.use_specific_seeds)
                    else 42 + seed_id * 1000 + idx)
            neg_ids = torch.from_numpy(tokenizer([negatives[idx] if negatives else ""]))
            t0 = time.perf_counter()
            videos = pipe(
                torch.from_numpy(tokenizer([prompt])), neg_ids, plucker, c2w=c2w_t, K_mats=K_t,
                num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale, multistep=args.multistep,
                accumulate_step=args.accumulate_step, pab_config=pab_config,
                step_chunk=args.step_chunk,
                generator=torch.Generator(device=device).manual_seed(seed))
            seconds = time.perf_counter() - t0
            sub = os.path.join(args.out_root, f"{seed_id}_{idx:04d}")
            if not lead:
                results.append({"videos": None, "seconds": seconds, "out": sub,
                                "unet_step_ms": list(pipe.unet_step_ms),
                                "program": dict(pipe.program.stats)})
                continue
            videos = videos.cpu().numpy()                      # [V, F, H, W, 3]
            logger.info(f"[inference_advanced] [seed {seed_id} prompt {idx}] {prompt!r} "
                        f"seed={seed}: {seconds:.2f} s")

            save_npy(videos, os.path.join(sub, "videos.npy"))
            frames_meta = [(os.path.join("images", str(v), f"{i:04d}.png"), c2ws[v * F + i])
                           for v in range(V) for i in range(F)]
            if have_imageio():
                stacked = videos.transpose(1, 0, 2, 3, 4).reshape(F, V * S, S, 3)
                save_video(stacked, os.path.join(sub, "video.gif"))
                save_video(stacked, os.path.join(sub, "video.mp4"))
                for v in range(V):
                    save_video_as_images(videos[v], os.path.join(sub, "images", str(v)))
            export_transforms_json(os.path.join(sub, "transforms.json"), intr, frames_meta, args)
            results.append({"videos": videos, "seconds": seconds, "out": sub,
                            "unet_step_ms": list(pipe.unet_step_ms),
                            "program": dict(pipe.program.stats)})
    return results


def build_parser() -> argparse.ArgumentParser:
    from cvd_tpu_torch.cli.build import add_model_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out_root", required=True)
    p.add_argument("--image_height", type=int, default=256)
    p.add_argument("--image_width", type=int, default=256)
    p.add_argument("--video_length", type=int, default=16)
    add_model_args(p)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--guidance_scale", type=float, default=8.5)
    p.add_argument("--caption_file", required=True)
    p.add_argument("--use_negative_prompt", action="store_true",
                   help="read per-prompt negative_prompts from the caption json")
    p.add_argument("--use_specific_seeds", action="store_true")
    p.add_argument("--zero_first_frame_scale", action="store_true", default=True,
                   help="identity-first pose normalization; procedural "
                        "trajectories start at identity so both settings "
                        "coincide here (as in the reference, whose "
                        "get_relative_pose is never called on this path)")
    p.add_argument("--view_num", type=int, default=4)
    p.add_argument("--multistep", type=int, default=3)
    p.add_argument("--accumulate_step", type=int, default=1)
    p.add_argument("--multiseed", type=int, default=1)
    p.add_argument("--cam_pattern", choices=["circle", "upper_hemi", "interpolate"],
                   default="circle")
    p.add_argument("--camera_dist", type=float, default=1.0)
    p.add_argument("--cam_perturb_traj", type=float, default=0.0)
    p.add_argument("--fix_firstframe", action="store_true")
    p.add_argument("--mono_direction", action="store_true",
                   help="not supported: the reference raises too")
    p.add_argument("--sharded", action="store_true",
                   help="sample over a (rows x frames) mesh of the processes torchrun starts "
                        "(one per card, or gloo with --device cpu); rank 0 writes")
    p.add_argument("--pab", action="store_true",
                   help="Pyramid Attention Broadcast: reuse attention outputs on scheduled "
                        "outer steps (see pipelines/pab.py)")
    p.add_argument("--pab_ranges", type=str, default="",
                   help="per-class broadcast ranges, e.g. 'spatial=2,cross=3,temporal=2,epi=1'")
    p.add_argument("--step_chunk", type=int, default=None,
                   help="timesteps per CUDA graph of the denoising loop (default 1); the "
                        "latents do not depend on it")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())

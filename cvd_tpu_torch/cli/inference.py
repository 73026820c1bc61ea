"""2-view inference CLI (port of ``cvd_tpu/cli/inference.py``).

    python -m cvd_tpu_torch.cli.inference --bf16 \
        --ori_model_path <SD1.5 folder> --unet_subfolder unet_webvidlora_v3 \
        --motion_module_ckpt v3_sd15_mm.ckpt --epi_module_ckpt <cvd epi .ckpt> \
        --pose_adaptor_ckpt CameraCtrl.ckpt --model_config configs/inference_config.yaml \
        --caption_file assets/example_prompts.json --use_negative_prompt \
        --pose_file_0 assets/pose_files/example_dolly.txt \
        --pose_file_1 assets/pose_files/example_arc.txt --out_root results/

Without checkpoints, ``--random-weights-full`` takes the place of the five
weight options (SD1.5 widths, seeded random tensors). ``--multidiff_total_steps
N --multidiff_overlaps O`` denoises N overlapping windows of
``--video_length`` frames, N * (video_length - O) + O frames in all (at most
the pose encoder's 16); ``--pab [--pab_ranges ...]`` turns on Pyramid
Attention Broadcast.

Each prompt writes ``<out_root>/<idx>/videos.npy`` (uint8 [2, F, H, W, 3])
and, where ``imageio`` is installed, per-view png frames (``imgs/<v>/``)
and ``vids/<v>.mp4``, the two views side by side (``vids/horizontal.mp4``)
and one above the other (``vids/vertical.mp4``); without ffmpeg each mp4 is
a gif. ``--save_trajectory`` writes ``poses/pose_img_<v>.png`` and
``poses/ret_c2w_<v>.npy`` (needs matplotlib: without it the run stops before
the model is built). The run log is ``<out_root>/log_p0.txt``; it names the
files that were not written and why. ``--no_lora_validation`` and
``--scan_layers`` are taken and do nothing, as in the JAX package.

``--sharded`` samples over a ("rows", "frames") mesh of the processes that
``torchrun`` starts (``parallel/mesh.py``: rows = gcd(4, world), frames =
world / rows), NCCL on ``cuda:LOCAL_RANK`` or gloo with ``--device cpu``:

    torchrun --nproc_per_node 4 -m cvd_tpu_torch.cli.inference --sharded ...

Rank 0 alone decodes, logs and writes; not with ``--pab``, and the mesh must
divide the 4 CFG rows and the ``--video_length`` frames of a window.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List

import numpy as np
import torch


def load_prompts(caption_file: str, use_negative: bool, num_videos=None):
    if caption_file.endswith(".json"):
        with open(caption_file) as f:
            data = json.load(f)
        captions = data.get("captions", data.get("prompts"))
        if isinstance(captions[0], dict):
            captions = [c["caption"] for c in captions]
        negatives = data.get("negative_prompts") if use_negative else None
        if negatives is not None and len(negatives) != len(captions):
            raise SystemExit(f"--use_negative_prompt: negative_prompts has "
                             f"{len(negatives)} entries but captions has {len(captions)}")
        seeds = data.get("seeds")
    else:
        with open(caption_file) as f:
            captions = [line.strip() for line in f if line.strip()]
        negatives, seeds = None, None
    if num_videos:
        captions = captions * num_videos
        negatives = negatives * num_videos if negatives else None
    return captions, negatives, seeds


def main(args, tokenizer=None, widths=None, capture: bool = True) -> List[dict]:
    """Runs every prompt. Returns one record per prompt: ``videos`` (f32
    [2, F, H, W, 3] in [0, 1]), ``seconds`` (wall time of the request),
    ``unet_step_ms`` (each UNet call of the DDIM loop) and ``program`` (how
    the sampler ran it: ``SamplingProgram.stats``). ``capture``:
    ``SimplePipeline``'s (False: the timesteps run eagerly on the card
    too). ``tokenizer``: an object to tokenize with in place of the one the
    weights come with.
    ``widths``: ``build_modules``'s, for checkpoint files narrower than
    SD1.5's. With ``--sharded`` every rank returns the records, and only
    rank 0's hold the videos (the others' are None)."""
    from cvd_tpu_torch.cli.build import resolve_device
    from cvd_tpu_torch.parallel.mesh import inference_mesh, process_group
    from cvd_tpu_torch.parallel.shard_ops import check_divides
    from cvd_tpu_torch.pipelines.pab import PABConfig
    from cvd_tpu_torch.utils.visualize import have_matplotlib

    if args.pab and args.sharded:
        raise SystemExit("--pab + --sharded is not validated; pick one")
    if args.image_width != args.image_height:
        raise SystemExit("the epipolar attention assumes a square token grid: "
                         "use --image_width == --image_height")
    if args.save_trajectory and not have_matplotlib():
        raise RuntimeError("--save_trajectory plots the cameras with matplotlib, which is not "
                           "installed")
    pab_config = None
    if args.pab:
        pab_config = PABConfig.from_string(args.pab_ranges) if args.pab_ranges else PABConfig()
        if args.multidiff_total_steps != 1:
            raise ValueError("PAB + multidiff windows is unsupported")
    # all frames of the multidiff windows (cvd_tpu/cli/inference.py:100-116)
    F = (args.multidiff_total_steps * (args.video_length - args.multidiff_overlaps)
         + args.multidiff_overlaps if args.multidiff_total_steps > 1 else args.video_length)
    if not args.sharded:
        return _requests(args, F, pab_config, resolve_device(args.device), None, tokenizer,
                         widths, capture)
    with process_group(args.device, "--sharded", "cvd_tpu_torch.cli.inference") as (_, world,
                                                                                    device):
        mesh = inference_mesh(world)
        check_divides(mesh, 4, args.video_length, "--sharded")
        return _requests(args, F, pab_config, device, mesh, tokenizer, widths, capture)


def _requests(args, F, pab_config, device, mesh, tokenizer, widths,
              capture) -> List[dict]:
    """``main``'s requests on ``device``, over ``mesh`` where one is given
    (rank 0 alone logs and writes, and holds the videos)."""
    from cvd_tpu_torch.cli.build import SD15_WIDTHS, build_modules
    from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded
    from cvd_tpu_torch.parallel.mesh import replicate
    from cvd_tpu_torch.pipelines.simple import SimplePipeline
    from cvd_tpu_torch.utils.logging import setup_logger
    from cvd_tpu_torch.utils.video import (
        have_imageio, save_npy, save_video, save_video_as_images, save_videos_grid,
    )
    from cvd_tpu_torch.utils.visualize import save_trajectory_plot

    captions, negatives, seeds = load_prompts(
        args.caption_file, args.use_negative_prompt, args.num_videos)
    lead = mesh is None or mesh.rank == 0
    logger = setup_logger(args.out_root if lead else None, name="cvd_tpu_torch.inference",
                          process_index=0 if lead else mesh.rank)
    if not have_imageio():
        logger.info("imageio is not installed: each prompt writes videos.npy only, no "
                    "imgs/<v>/*.png and no vids/{<v>,horizontal,vertical}.mp4")
    t0 = time.perf_counter()
    modules, tokenizer = build_modules(args, device, tokenizer=tokenizer,
                                       widths=widths or SD15_WIDTHS)
    logger.info(f"[inference] built modules on {device} in {time.perf_counter() - t0:.1f} s")
    if mesh is not None:
        for module in (modules.unet, modules.vae, modules.clip, modules.pose_encoder):
            replicate(module, mesh)
        logger.info(f"[inference] sharded sampling over mesh {mesh.shape}")
    pipe = SimplePipeline(modules, F_mat_size=args.image_height, rand_slope_ff=True,
                          mesh=mesh, capture=capture)
    dataset = ValRealEstate10KPoseFolded(
        validation_prompts=captions,
        validation_negative_prompts=negatives,
        pose_file_0=args.pose_file_0,
        pose_file_1=args.pose_file_1,
        sample_n_frames=F,
        sample_size=args.image_height,
        zero_first_frame_scale=args.zero_first_frame_scale,
    )
    S = args.image_height
    results = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        seed = seeds[idx] if (seeds and args.use_specific_seeds) else args.global_seed + idx
        prompt_ids = torch.from_numpy(tokenizer([sample["validation_prompt"]]))
        neg_ids = torch.from_numpy(tokenizer([sample.get("validation_negative_prompt", "")]))
        plucker = torch.from_numpy(sample["plucker_embedding"]).float().reshape(2, F, S, S, 6)
        F_mats = torch.from_numpy(sample["F_mats"]).float().reshape(2, F, 3, 3)
        t0 = time.perf_counter()
        videos = pipe(prompt_ids, neg_ids, plucker, F_mats,
                      num_inference_steps=args.num_inference_steps,
                      guidance_scale=args.guidance_scale,
                      generator=torch.Generator(device=device).manual_seed(seed),
                      multidiff_total_steps=args.multidiff_total_steps,
                      multidiff_overlaps=args.multidiff_overlaps, pab_config=pab_config)
        videos = None if videos is None else videos.cpu().numpy()
        seconds = time.perf_counter() - t0
        if not lead:
            results.append({"videos": None, "seconds": seconds,
                            "unet_step_ms": list(pipe.unet_step_ms),
                            "program": dict(pipe.program.stats)})
            continue
        logger.info(f"[inference] [{idx}] {sample['validation_prompt']!r} seed={seed}: "
                    f"{seconds:.2f} s")
        out = os.path.join(args.out_root, str(idx))
        save_npy(videos, os.path.join(out, "videos.npy"))
        if have_imageio():
            vids = os.path.join(out, "vids")
            for v in range(2):
                save_video_as_images(videos[v], os.path.join(out, "imgs", str(v)))
                save_video(videos[v], os.path.join(vids, f"{v}.mp4"))
            save_video(np.concatenate([videos[0], videos[1]], axis=2),
                       os.path.join(vids, "horizontal.mp4"))
            save_videos_grid(videos, os.path.join(vids, "vertical.mp4"), n_rows=2)
        if args.save_trajectory:
            # the JAX package's reshape: args.video_length poses a plot
            save_trajectory_plot(sample["ret_c2w"], os.path.join(out, "poses"),
                                 args.video_length)
        written = sorted(os.path.relpath(os.path.join(d, f), out)
                         for d, _, files in os.walk(out) for f in files)
        frames = [w for w in written if w.startswith("imgs")]
        logger.info(f"[inference] [{idx}] wrote under {out}: "
                    + ", ".join(w for w in written if w not in frames)
                    + (f" and {len(frames)} frames under imgs/" if frames else ""))
        results.append({"videos": videos, "seconds": seconds,
                        "unet_step_ms": list(pipe.unet_step_ms),
                        "program": dict(pipe.program.stats)})
    return results


def build_parser() -> argparse.ArgumentParser:
    from cvd_tpu_torch.cli.build import add_model_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out_root", default="results")
    p.add_argument("--image_height", type=int, default=256)
    p.add_argument("--image_width", type=int, default=256)
    p.add_argument("--video_length", type=int, default=16)
    add_model_args(p)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--multidiff_total_steps", type=int, default=1,
                   help="sliding denoise windows for videos longer than --video_length "
                        "(total frames = steps*(video_length-overlaps)+overlaps)")
    p.add_argument("--multidiff_overlaps", type=int, default=12)
    p.add_argument("--guidance_scale", type=float, default=8.5)
    p.add_argument("--caption_file", required=True)
    p.add_argument("--use_negative_prompt", action="store_true")
    p.add_argument("--use_specific_seeds", action="store_true")
    p.add_argument("--zero_first_frame_scale", action="store_true", default=True)
    p.add_argument("--preserve_first_frame_scale", dest="zero_first_frame_scale",
                   action="store_false")
    p.add_argument("--global_seed", type=int, default=1024)
    p.add_argument("--pose_file_0", required=True)
    p.add_argument("--pose_file_1", required=True)
    p.add_argument("--num_videos", type=int, default=None)
    p.add_argument("--no_lora_validation", action="store_true",
                   help="taken and ignored, as in the JAX package")
    p.add_argument("--save_trajectory", action="store_true",
                   help="plot each view's cameras (poses/pose_img_<v>.png, needs matplotlib) "
                        "and save them (poses/ret_c2w_<v>.npy)")
    p.add_argument("--sharded", action="store_true",
                   help="sample over a (rows x frames) mesh of the processes torchrun starts "
                        "(one per card, or gloo with --device cpu); rank 0 writes")
    p.add_argument("--pab", action="store_true",
                   help="Pyramid Attention Broadcast: reuse cached attention outputs on "
                        "scheduled mid-trajectory steps (see pipelines/pab.py)")
    p.add_argument("--pab_ranges", type=str, default="",
                   help="e.g. 'spatial=2,cross=3,temporal=2,epi=1'")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())

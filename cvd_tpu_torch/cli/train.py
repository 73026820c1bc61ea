"""Training CLI (port of ``cvd_tpu/cli/train.py``, the reference's
``train_epi_control.py``), on one device.

    python -m cvd_tpu_torch.cli.train --config configs/train_epi.yaml

Fine-tunes only the epi/sync/auxiliary parameters on folded RealEstate10K
pairs (with ``sync_lora_rank`` the sync-LoRA trains beside the epi modules,
and ``image_lora_ckpt``'s runtime image LoRA stays frozen at scale 1): null-text dropout, periodic logging and checkpoints (the port's
``save`` file and the reference-format ``.ckpt``), ``resume_from`` and a
first-step sanity dump; ``remat: true`` recomputes each UNet block in the
backward (off by default: PERF.md). ``run(cfg)`` takes the config as a
dict and leaves a ``config.yaml`` snapshot of it in ``output_dir``;
``sources`` replaces the on-disk dataset with in-memory ones.

Weights: ``ori_model_path`` (an SD1.5 diffusers folder; ``unet_subfolder``),
``motion_module_ckpt``, ``pose_adaptor_ckpt`` and, to go on from a trained
one, ``epi_module_ckpt`` (else the epi modules start as the identity), with
the modules that ``model_config`` names; or ``random_weights: true``, the tiny smoke
model from the default initialization, or ``random_weights_full: true``,
the SD1.5 widths with every tensor drawn, on the device from a fixed seed.
``lora_rank`` is the image LoRA's rank, as in the JAX package (and so the
sync-LoRA's divisor with an image LoRA); ``epi_loss_weight`` weighs the
epipolar distance loss of the auxiliary q/k head, which a model config with
``additional_channel > 0`` adds (without it the loss is 0 and weighs
nothing, as in the JAX package). ``cache_latents: true`` encodes the first
``latents_cache_items`` clips once into ``latents_cache_dir`` (default
``<output_dir>/latents_cache``; built on the first run, reused after) and
trains from their posterior moments (``data/latents_cache.py``).
``validation_steps: N`` samples ``validation_data``'s pose pair with the
live weights every N steps (``validation_steps_num`` DDIM steps) into
``<output_dir>/validation/step-<N>.npy`` and, where imageio is installed,
``step-<N>.gif`` and ``step-<N>-epi.png``. Not ported yet, and raising
NotImplementedError (ROADMAP queue 1): ``civitai_*``, datasets other than
RealEstate10K, ``--multihost``, remat policies other than ``""``, process
workers.
"""
from __future__ import annotations

import argparse
import os
import random
import time
from typing import Optional, Sequence

import numpy as np
import torch

_CHECKPOINT_KEYS = ("image_lora_ckpt", "civitai_lora_ckpt", "civitai_base_model")
_ROADMAP = "(ROADMAP queue 1, training)"


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _model_args(cfg: dict) -> argparse.Namespace:
    """The config's keys as ``cli.build``'s model options: ``lora_rank`` is
    ``--image_lora_rank`` (cvd_tpu/cli/train.py:127)."""
    return argparse.Namespace(
        **{k: cfg.get(k) for k in ("ori_model_path", "motion_module_ckpt", "motion_lora_ckpt",
                                   "epi_module_ckpt", "pose_adaptor_ckpt", "model_config")
           + _CHECKPOINT_KEYS},
        unet_subfolder=cfg.get("unet_subfolder") or "unet",
        motion_lora_scale=cfg.get("motion_lora_scale", 1.0),
        random_weights=bool(cfg.get("random_weights")),
        random_weights_full=bool(cfg.get("random_weights_full")),
        pose_adaptor_scale=cfg.get("pose_adaptor_scale", 1.0), bf16=cfg.get("bf16", False),
        image_lora_rank=cfg.get("lora_rank", 4),
        sync_lora_rank=cfg.get("sync_lora_rank", 0) or 0,
        sync_lora_scale=cfg.get("sync_lora_scale", 1.0),
        remat_policy=cfg.get("remat_policy", "") or "")


def _refuse_unported(cfg: dict) -> None:
    from cvd_tpu_torch.cli.build import refuse_unported

    name = (cfg.get("train_data") or {}).get("dataset_name", "realestate10k")
    if name not in ("realestate10k", "realestate10k_local"):
        raise NotImplementedError(f"dataset_name {name!r}: only RealEstate10K is ported "
                                  f"{_ROADMAP}")
    refuse_unported(_model_args(cfg))


def build_training_modules(cfg: dict, device, tokenizer=None, widths=None):
    """-> (modules with the VAE encoder, tokenizer) through
    ``cli.build.build_modules``, the config's keys as its options: UNet in
    f32 (``create_train_state`` casts its frozen part), VAE / CLIP / pose
    encoder in bf16 when ``bf16``."""
    from cvd_tpu_torch.cli.build import SD15_WIDTHS, build_modules

    return build_modules(_model_args(cfg), device, vae_encoder=True, unet_dtype=torch.float32,
                         tokenizer=tokenizer, widths=widths or SD15_WIDTHS)


def _frozen_dtype(cfg: dict) -> Optional[torch.dtype]:
    """The frozen UNet weights' dtype, which the UNet computes in: bfloat16
    unless ``frozen_weights_dtype`` says otherwise, whatever ``bf16`` says
    (that key is for the VAE, CLIP and the pose encoder)."""
    name = cfg.get("frozen_weights_dtype", "bfloat16")
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float32": torch.float32, "f32": torch.float32}[name]


def run_validation(modules, tokenizer, cfg: dict, out_dir: str, step: int, logger):
    """Sample ``validation_data``'s pose pair (its first prompt) with the
    live training weights, as the JAX package does (cli/train.py:25-75): the
    training UNet itself under ``torch.no_grad`` (no copy; its mode is
    restored after), ``validation_steps_num`` DDIM steps from a generator of
    its own seeded with ``step`` (no number is drawn from the training
    generators). Writes ``validation/step-<step>.npy`` (uint8 [2, F, H, W, 3])
    and, with imageio, the 2-row ``step-<step>.gif`` and the epipolar overlay
    of the middle frames, ``step-<step>-epi.png``. Without ``pose_file_0``
    nothing runs, as in the JAX package."""
    from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded
    from cvd_tpu_torch.pipelines.simple import SimplePipeline
    from cvd_tpu_torch.utils.video import have_imageio, save_npy, save_videos_grid
    from cvd_tpu_torch.utils.visualize import check_fundamental

    vcfg = cfg.get("validation_data") or {}
    if not vcfg.get("pose_file_0"):
        return
    n, size = cfg.get("sample_n_frames", 16), cfg.get("sample_size", 256)
    sample = ValRealEstate10KPoseFolded(
        validation_prompts=vcfg.get("prompts", ["a scenic video"]),
        pose_file_0=vcfg["pose_file_0"], pose_file_1=vcfg["pose_file_1"],
        sample_n_frames=n, sample_size=size)[0]
    unet = modules.unet
    device = unet.conv_in.weight.device
    was_training = unet.training
    unet.eval()
    try:
        vids = SimplePipeline(modules, F_mat_size=size)(
            torch.from_numpy(tokenizer([sample["validation_prompt"]])),
            torch.from_numpy(tokenizer([""])),
            torch.from_numpy(sample["plucker_embedding"]).float().reshape(2, n, size, size, 6),
            torch.from_numpy(sample["F_mats"]).float().reshape(2, n, 3, 3),
            num_inference_steps=cfg.get("validation_steps_num", 25),
            generator=torch.Generator(device=device).manual_seed(step))
    finally:
        unet.train(was_training)
    vids = vids.cpu().numpy()
    vdir = os.path.join(out_dir, "validation")
    save_npy(vids, os.path.join(vdir, f"step-{step}.npy"))
    if have_imageio():
        import imageio

        save_videos_grid(vids, os.path.join(vdir, f"step-{step}.gif"), n_rows=2)
        overlay = check_fundamental(vids[0, n // 2], vids[1, n // 2], sample["F_mats"][n // 2])
        imageio.imwrite(os.path.join(vdir, f"step-{step}-epi.png"), overlay)
        logger.info(f"validation at step {step}: {vdir}/step-{step}.{{npy,gif}}, -epi.png")
    else:
        logger.info(f"validation at step {step}: {vdir}/step-{step}.npy; step-{step}.gif and "
                    f"step-{step}-epi.png not written: imageio is not installed")


def _latents_cache(cfg: dict, dataset, modules, out_dir: str, logger):
    """The latents cache of ``dataset`` (cvd_tpu/cli/train.py:198-227): built
    on the first run into ``latents_cache_dir``, capped at
    ``latents_cache_items``, reused after. -> (the cached dataset, {"dir",
    "built", "items", "seconds", "item_seconds"})."""
    from cvd_tpu_torch.data.latents_cache import CachedLatentsDataset, build_latents_cache

    cdir = cfg.get("latents_cache_dir") or os.path.join(out_dir, "latents_cache")
    report = {"dir": cdir, "built": False, "items": 0, "seconds": 0.0, "item_seconds": []}
    if not os.path.isdir(cdir) or not any(f.endswith(".npz") for f in os.listdir(cdir)):
        logger.info(f"building latents cache at {cdir}")
        report.update(built=True, **build_latents_cache(
            dataset, modules, cdir, num_items=cfg.get("latents_cache_items"),
            log=logger.info))
    return CachedLatentsDataset(cdir), report


def run(cfg: dict, sources: Optional[Sequence] = None, tokenizer=None, widths=None) -> dict:
    """The training loop. ``sources``: map-style datasets with the sample
    keys of ``RealEstate10KPoseFolded`` (default: the one ``train_data``
    names). ``tokenizer``: an object to tokenize with in place of the one the
    weights come with. ``widths``: ``build_modules``'s, for checkpoint files
    narrower than SD1.5's. Returns {"state", "modules", "losses", "epi_losses",
    "step_seconds", "global_step", "epoch", "out_dir", "latents_cache"
    (``_latents_cache``'s report, or None)}."""
    from cvd_tpu_torch.cli.build import resolve_device
    from cvd_tpu_torch.data.loader import DataLoader
    from cvd_tpu_torch.data.realestate10k import RealEstate10KPoseFolded
    from cvd_tpu_torch.train.checkpoint import restore, save, save_reference_ckpt
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import train_step
    from cvd_tpu_torch.utils.logging import MetricsLogger, format_time, setup_logger

    _refuse_unported(cfg)
    device = resolve_device(cfg.get("device"))
    out_dir = cfg.get("output_dir", "runs/train")
    os.makedirs(out_dir, exist_ok=True)
    logger = setup_logger(out_dir)
    metrics_log = MetricsLogger(out_dir)
    import yaml

    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)   # the snapshot of what this run was asked for
    n_frames = cfg.get("sample_n_frames", 16)
    sample_size = cfg.get("sample_size", 256)
    seed = cfg.get("global_seed", 42)

    modules, tokenizer = build_training_modules(cfg, device, tokenizer, widths)
    if sources is None:
        train_cfg = cfg.get("train_data") or {}
        sources = [RealEstate10KPoseFolded(
            root_path=train_cfg["root_path"], sample_stride=train_cfg.get("sample_stride", 2),
            sample_n_frames=n_frames, sample_size=sample_size, seed=seed)]
    if len(sources) != 1:
        raise NotImplementedError(f"hybrid (several) data sources are not ported yet {_ROADMAP}")
    cache = None
    if cfg.get("cache_latents", False):
        cached, cache = _latents_cache(cfg, sources[0], modules, out_dir, logger)
        sources = [cached]
    loader = DataLoader(sources[0], batch_size=cfg.get("train_batch_size", 1),
                        num_workers=cfg.get("num_workers", 8),
                        worker_type=cfg.get("worker_type", "thread"), seed=seed)
    logger.info(f"dataset: {len(sources[0])} clips, {len(loader)} steps/epoch")
    if len(loader) == 0:
        raise SystemExit(f"empty dataset/loader (batch={cfg.get('train_batch_size', 1)}): "
                         "nothing to train on")

    max_steps = cfg.get("max_train_steps", 100_000)
    state = create_train_state(
        modules.unet, learning_rate=cfg.get("learning_rate", 1e-4),
        adam_weight_decay=cfg.get("adam_weight_decay", 1e-2),
        max_grad_norm=cfg.get("max_grad_norm", 1.0),
        scheduler=cfg.get("lr_scheduler", "constant"),
        warmup_steps=cfg.get("lr_warmup_steps", 0), total_steps=max_steps,
        frozen_dtype=_frozen_dtype(cfg))
    global_step, epoch = 0, 0
    if cfg.get("resume_from"):
        state, epoch = restore(cfg["resume_from"], state)
        global_step = state.step
        logger.info(f"resumed from {cfg['resume_from']} at step {global_step}")

    ckpt_every = cfg.get("checkpointing_steps", 5000)
    log_every = cfg.get("logger_interval", 10)
    null_ratio = cfg.get("cfg_random_null_text_ratio", 0.1)
    # block remat off by default: on an 80 GB H100 a 16-frame 256 px step
    # peaks at 22.7 GiB without it (13.4 with) and runs 27% faster (PERF.md)
    remat = cfg.get("remat", False)
    generator = torch.Generator(device=device).manual_seed(seed)
    pyrng = random.Random(seed)

    def fold(x):
        # the 2F-frame pair, video-major like torch.cat(chunk(2, 1)) (:516)
        return torch.from_numpy(np.concatenate([x[:, :n_frames], x[:, n_frames:]], axis=0))

    def fold_batch(batch, texts):
        if "plucker_embedding" not in batch:
            raise NotImplementedError(f"unposed (WebVid) batches are not ported yet {_ROADMAP}")
        moments = ("latent_mean", "latent_logvar") if "latent_mean" in batch else ("pixel_values",)
        return {"text_ids": torch.from_numpy(np.concatenate([tokenizer(texts)] * 2, axis=0)),
                **{k: fold(batch[k]) for k in moments},
                "plucker": fold(batch["plucker_embedding"]),
                "F_mats": fold(batch["F_mats"])}

    def sanity_dump(batch):
        """First-step dumps of the raw batch (do_sanity_check,
        train_epi_control.py:503-510) and an epipolar overlay of the training
        pair (:419-431): .npy always, GIF/PNG where imageio imports."""
        from cvd_tpu_torch.utils.video import have_imageio, save_videos_grid
        from cvd_tpu_torch.utils.visualize import check_fundamental

        sdir = os.path.join(out_dir, "sanity_check")
        os.makedirs(sdir, exist_ok=True)
        px = batch["pixel_values"]                          # [b, 2F, H, W, 3] in [-1, 1]
        mid = n_frames // 2
        overlay = check_fundamental(px[0, mid], px[0, n_frames + mid], batch["F_mats"][0, mid])
        np.save(os.path.join(sdir, "epi_overlay.npy"), overlay)
        if have_imageio():
            import imageio

            imageio.imwrite(os.path.join(sdir, "epi_overlay.png"), overlay)
            for i, text in enumerate(batch["text"]):
                name = "-".join(text.replace("/", "").split()[:10]) or f"0-{i}"
                save_videos_grid((px[i:i + 1] + 1) / 2, os.path.join(sdir, f"{name}.gif"))

    def endless():
        while True:
            yield from loader

    batches = endless()
    steps_per_epoch = max(1, len(loader))
    draws = global_step
    losses, epi_losses, step_seconds = [], [], []
    val_every = cfg.get("validation_steps") or 0
    logger.info("training starts")
    while global_step < max_steps:
        t_data = time.perf_counter()
        batch = next(batches)
        draws += 1
        texts = ["" if pyrng.random() < null_ratio else t for t in batch["text"]]
        if cfg.get("do_sanity_check", True) and global_step == 0 and "pixel_values" in batch:
            sanity_dump(batch)    # cached-latents batches carry no pixels
        device_batch = fold_batch(batch, texts)
        t0 = time.perf_counter()
        m = train_step(state, device_batch, modules, generator, F_mat_size=sample_size,
                       remat=remat, epi_loss_weight=cfg.get("epi_loss_weight", 0.002))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_seconds.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        epi_losses.append(m["epi_loss"])
        global_step += 1
        if global_step % log_every == 0:
            logger.info(f"iter {global_step}/{max_steps} loss {m['loss']:.4f} "
                        f"epi {m['epi_loss']:.4f} data {t0 - t_data:.2f}s "
                        f"iter {step_seconds[-1]:.2f}s "
                        f"ETA {format_time(step_seconds[-1] * (max_steps - global_step))}")
            metrics_log.log(global_step, loss=m["loss"], epi_loss=m["epi_loss"],
                            grad_norm=m["grad_norm"])
        if val_every and global_step % val_every == 0:
            run_validation(modules, tokenizer, cfg, out_dir, global_step, logger)
        if global_step % ckpt_every == 0:
            ck = os.path.join(out_dir, "checkpoints")
            save(os.path.join(ck, f"step-{global_step}.pt"), state, epoch)
            save_reference_ckpt(os.path.join(ck, f"checkpoint-step-{global_step}.ckpt"),
                                state, epoch, global_step)
            logger.info(f"saved checkpoint at step {global_step}")
        epoch = draws // steps_per_epoch
    logger.info("training done")
    return {"state": state, "modules": modules, "losses": losses, "epi_losses": epi_losses,
            "step_seconds": step_seconds, "global_step": global_step, "epoch": epoch,
            "out_dir": out_dir, "latents_cache": cache}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training (not ported yet)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.multihost:
        raise NotImplementedError(f"--multihost is not ported yet {_ROADMAP}: multi-GPU DDP")
    return run(load_config(args.config))


if __name__ == "__main__":
    main()

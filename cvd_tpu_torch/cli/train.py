"""Training CLI (port of ``cvd_tpu/cli/train.py``, the reference's
``train_epi_control.py``).

    python -m cvd_tpu_torch.cli.train --config configs/train_epi.yaml
    torchrun --nproc_per_node N -m cvd_tpu_torch.cli.train --config C --multihost

Fine-tunes only the epi/sync/auxiliary parameters on folded pairs (with
``sync_lora_rank`` the sync-LoRA trains beside the epi modules, and
``image_lora_ckpt``'s runtime image LoRA stays frozen, at scale 1 on posed
steps and 0 on unposed ones): null-text dropout, periodic logging and
checkpoints (the port's ``save`` file and the reference-format ``.ckpt``),
``resume_from`` and a first-step sanity dump. ``run(cfg)`` takes the config
as a dict and leaves a ``config.yaml`` snapshot of it in ``output_dir``;
``sources`` replaces the datasets ``train_data`` names with in-memory ones.

Data: ``train_data.dataset_name`` is ``realestate10k`` (or
``realestate10k_local``; posed pairs from ``root_path``),
``realestate10k_remote`` / ``webvid10m_remote`` (streamed from ``base_url``
into ``cache_dir``), ``webvid10m`` (unposed clips from ``root_path``, pairs
made by a random homography) or ``hybrid`` (``posed_ratio`` and the
sub-configs ``realestate10k`` and ``webvid10m``). Each step draws one source
by weight (``random.Random(global_seed + 1)``, the JAX package's sequence),
so a batch is all posed or all unposed; an epoch counts the draws of the
first source. ``worker_type: process`` forks ``num_workers`` decode
processes per epoch (``data/loader.py``).

On a CUDA device each step is a replay of a CUDA graph of the whole step
(``train/program.py``, the counterpart of cvd_tpu's jitted step): one graph
per static key (the batch's kind, keys, shapes and dtypes, the remat
settings, the auxiliary head), so a hybrid run alternates between two; the
first step of each key runs eagerly and is then captured.
``run(cfg, capture=False)``, the CPU and ``--multihost`` run the same step
eagerly.

``remat: true`` recomputes activations in the backward (off by default:
PERF.md), per ``remat_unit`` (``block`` or ``layer``) keeping what
``remat_policy`` saves (``""``, ``dots``, ``dots_no_batch``, ``dots_small``;
``models/unet.py``); either one set with ``remat: false`` raises.

``--multihost``: data-parallel training over the processes that ``torchrun``
starts (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo with ``device: cpu``.
Each process loads its shard of every epoch and steps from a generator
seeded ``global_seed + rank``; the gradients are averaged before clipping;
process 0 alone logs, writes ``config.yaml``, validates and saves.

Weights: ``ori_model_path`` (an SD1.5 diffusers folder; ``unet_subfolder``),
``motion_module_ckpt``, ``pose_adaptor_ckpt`` and, to go on from a trained
one, ``epi_module_ckpt`` (else the epi modules start as the identity), with
the modules that ``model_config`` names; or ``random_weights: true``, the tiny smoke
model from the default initialization, or ``random_weights_full: true``,
the SD1.5 widths with every tensor drawn, on the device from a fixed seed.
``lora_rank`` is the image LoRA's rank, as in the JAX package (and so the
sync-LoRA's divisor with an image LoRA); ``epi_loss_weight`` weighs the
epipolar distance loss of the auxiliary q/k head, which a model config with
``additional_channel > 0`` adds (without it, and on unposed steps, the loss
is 0 and weighs nothing, as in the JAX package). ``cache_latents: true``
encodes the first ``latents_cache_items`` clips of the posed source once
into ``latents_cache_dir`` (default ``<output_dir>/latents_cache``; built on
the first run, reused after) and trains from their posterior moments
(``data/latents_cache.py``). ``validation_steps: N`` samples
``validation_data``'s pose pair with the live weights every N steps
(``validation_steps_num`` DDIM steps) into
``<output_dir>/validation/step-<N>.npy`` and, where imageio is installed,
``step-<N>.gif`` and ``step-<N>-epi.png``. ``civitai_base_model`` and
``civitai_lora_ckpt`` swap in a civitai single-file model and fuse a kohya
LoRA, after the other files, as ``--civitai_*`` do (``cli/build.py``); the
frozen UNet then holds the civitai weights.
"""
from __future__ import annotations

import argparse
import os
import random
import time
from typing import Optional, Sequence

import numpy as np
import torch

# the process group of --multihost, shared with sampling's --sharded
from cvd_tpu_torch.parallel.mesh import process_group

_CHECKPOINT_KEYS = ("image_lora_ckpt", "civitai_lora_ckpt", "civitai_base_model")
# dataset_name -> the kind of its batches
_DATASETS = {"realestate10k": "posed", "realestate10k_local": "posed",
             "realestate10k_remote": "posed", "webvid10m": "unposed",
             "webvid10m_remote": "unposed", "hybrid": None}


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
        remat_unit=cfg.get("remat_unit", "block") or "block",
        remat_policy=cfg.get("remat_policy", "") or "")


def _refuse_unported(cfg: dict) -> None:
    """Raise for what the config asks and the port cannot do, before
    anything is built or read: an unknown ``dataset_name`` (SystemExit, as in
    the JAX package) and remat settings that ``remat: false`` would ignore
    (ValueError)."""
    name = (cfg.get("train_data") or {}).get("dataset_name", "realestate10k")
    if name not in _DATASETS:
        raise SystemExit(f"Unsupported dataset_name: {name!r} (one of {sorted(_DATASETS)})")
    if not cfg.get("remat", False) and (cfg.get("remat_policy") or
                                        cfg.get("remat_unit", "block") != "block"):
        raise ValueError(f"remat_policy {cfg.get('remat_policy')!r} / remat_unit "
                         f"{cfg.get('remat_unit')!r} act only with remat: true (remat is off)")


def _datasets(cfg: dict, n_frames: int, size: int, seed: int) -> list:
    """The sources ``train_data`` names: [(kind, dataset, weight)]
    (cvd_tpu/cli/train.py:141-196)."""
    from cvd_tpu_torch.data.realestate10k import RealEstate10KPoseFolded
    from cvd_tpu_torch.data.remote import RealEstate10KPoseFoldedRemote, WebVid10MRemote
    from cvd_tpu_torch.data.webvid import WebVidFolded

    common = dict(sample_n_frames=n_frames, sample_size=size, seed=seed)

    def make(name, c):
        if name in ("realestate10k", "realestate10k_local"):
            return RealEstate10KPoseFolded(root_path=c["root_path"],
                                           sample_stride=c.get("sample_stride", 2), **common)
        if name == "realestate10k_remote":
            return RealEstate10KPoseFoldedRemote(
                base_url=c["base_url"], cache_dir=c.get("cache_dir"),
                sample_stride=c.get("sample_stride", 2), **common)
        if name == "webvid10m":
            return WebVidFolded(root_path=c["root_path"], **common)
        return WebVid10MRemote(base_url=c["base_url"], cache_dir=c.get("cache_dir"), **common)

    train_cfg = cfg.get("train_data") or {}
    name = train_cfg.get("dataset_name", "realestate10k")
    if name == "hybrid":
        ratio = float(train_cfg.get("posed_ratio", 0.5))
        return [("posed", make("realestate10k", train_cfg["realestate10k"]), ratio),
                ("unposed", make("webvid10m", train_cfg["webvid10m"]), 1.0 - ratio)]
    return [(_DATASETS[name], make(name, train_cfg), 1.0)]


def _as_sources(sources: Sequence) -> list:
    """``run``'s ``sources``: a bare dataset is one posed source of weight 1;
    else (kind, dataset, weight) triples."""
    out = [s if isinstance(s, tuple) else ("posed", s, 1.0) for s in sources]
    bad = [kind for kind, _, _ in out if kind not in ("posed", "unposed")]
    if bad or not out:
        raise ValueError(f"sources: kinds {bad} (expected 'posed' or 'unposed'), "
                         f"{len(out)} sources")
    return out


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


def loader_stats(loaders) -> str:
    """The log line's reading of the loaders' ``stats``, over the run: the
    mean batches ready when a step asked, the seconds steps waited, the
    workers' busy seconds, the draws."""
    from cvd_tpu_torch.data.loader import PREFETCH

    total = {k: sum(loader.stats[k] for _, loader, _ in loaders)
             for k in ("draws", "ready", "wait_s", "busy_s")}
    return (f"ready {total['ready'] / max(total['draws'], 1):.1f}/{PREFETCH}, waited "
            f"{total['wait_s']:.2f}s, workers busy {total['busy_s']:.2f}s, "
            f"{total['draws']} draws")


def run(cfg: dict, sources: Optional[Sequence] = None, tokenizer=None, widths=None,
        multihost: bool = False, capture: bool = True) -> dict:
    """The training loop. ``sources``: map-style datasets with the sample
    keys of ``RealEstate10KPoseFolded`` (posed) or ``WebVidFolded``
    (unposed), each bare (one posed source) or as (kind, dataset, weight)
    (default: those ``train_data`` names). ``tokenizer``: an object to
    tokenize with in place of the one the weights come with. ``widths``:
    ``build_modules``'s, for checkpoint files narrower than SD1.5's.
    ``multihost``: data-parallel over the ``torchrun`` processes
    (``parallel.mesh.init_distributed``; a process group this call makes is
    destroyed at the end, one the process already holds is reused).
    ``capture``: on a CUDA device each step is a replay of one CUDA graph per
    static key (``train/program.py``); False runs the same step eagerly (as
    the CPU and ``multihost`` do).
    Returns {"state", "modules", "losses", "epi_losses", "kinds" (each step's
    source kind), "step_seconds", "global_step", "epoch", "out_dir",
    "latents_cache" (``_latents_cache``'s report, or None), "rank",
    "world_size", "program" (``TrainProgram.stats``: ``captured``, ``steps``,
    ``captures``, ``capture_s``, ``launches``)}."""
    from cvd_tpu_torch.cli.build import resolve_device

    _refuse_unported(cfg)
    if not multihost:
        return _run(cfg, sources, tokenizer, widths, resolve_device(cfg.get("device")),
                    capture=capture)
    with process_group(cfg.get("device"), "--multihost",
                       "cvd_tpu_torch.cli.train") as (rank, world, device):
        return _run(cfg, sources, tokenizer, widths, device, group=(rank, world),
                    capture=capture)


def _run(cfg, sources, tokenizer, widths, device, group=None, capture=True) -> dict:
    """``run``'s loop; ``group``: (rank, world size) of the process group."""
    from cvd_tpu_torch.data.loader import DataLoader
    from cvd_tpu_torch.train.checkpoint import restore, save, save_reference_ckpt
    from cvd_tpu_torch.train.program import TrainProgram
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.utils.logging import MetricsLogger, format_time, setup_logger

    rank, world = group or (0, 1)
    lead = rank == 0
    out_dir = cfg.get("output_dir", "runs/train")
    os.makedirs(out_dir, exist_ok=True)
    logger = setup_logger(out_dir, process_index=rank)
    metrics_log = MetricsLogger(out_dir, enabled=lead)
    if lead:
        import yaml

        with open(os.path.join(out_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)   # the snapshot of what this run was asked for
    n_frames = cfg.get("sample_n_frames", 16)
    sample_size = cfg.get("sample_size", 256)
    seed = cfg.get("global_seed", 42)

    modules, tokenizer = build_training_modules(cfg, device, tokenizer, widths)
    sources = (_datasets(cfg, n_frames, sample_size, seed) if sources is None
               else _as_sources(sources))
    cache = None
    if cfg.get("cache_latents", False):
        # posed sources only: an unposed batch's masks are made over pixels
        cached = []
        for kind, dataset, weight in sources:
            if kind == "posed":
                if world > 1 and not lead:
                    torch.distributed.barrier()     # process 0 builds the cache first
                dataset, report = _latents_cache(cfg, dataset, modules, out_dir, logger)
                cache = cache or report
                if world > 1 and lead:
                    torch.distributed.barrier()
            cached.append((kind, dataset, weight))
        sources = cached
    loaders = []
    for kind, dataset, weight in sources:
        loader = DataLoader(dataset, batch_size=cfg.get("train_batch_size", 1),
                            num_workers=cfg.get("num_workers", 8),
                            worker_type=cfg.get("worker_type", "thread"), seed=seed,
                            process_index=rank, process_count=world)
        logger.info(f"dataset[{kind}]: {len(dataset)} clips, {len(loader)} steps/epoch")
        if len(loader) == 0:
            raise SystemExit(f"empty {kind} dataset/loader (batch="
                             f"{cfg.get('train_batch_size', 1)}): nothing to train on")
        loaders.append((kind, loader, weight))

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
    # remat off by default: on an 80 GB H100 a 16-frame 256 px step peaks
    # at 22.7 GiB without it (13.4 with block remat) and runs 27% faster
    # (PERF.md)
    remat = cfg.get("remat", False)
    # the step's draws differ per process; the null-text and source draws
    # are the same on every process, so that all take one kind per step
    generator = torch.Generator(device=device).manual_seed(seed + rank)
    program = TrainProgram(state, modules, capture=capture, F_mat_size=sample_size, remat=remat,
                           epi_loss_weight=cfg.get("epi_loss_weight", 0.002))
    pyrng = random.Random(seed)
    sched_rng = random.Random(seed + 1)

    def fold(x):
        # the 2F-frame pair, video-major like torch.cat(chunk(2, 1)) (:516)
        return torch.from_numpy(np.concatenate([x[:, :n_frames], x[:, n_frames:]], axis=0))

    def fold_batch(batch, texts):
        moments = ("latent_mean", "latent_logvar") if "latent_mean" in batch else ("pixel_values",)
        geometry = (("plucker_embedding", "F_mats") if "plucker_embedding" in batch
                    else ("H_mats", "warped_masks"))
        return {"text_ids": torch.from_numpy(np.concatenate([tokenizer(texts)] * 2, axis=0)),
                **{("plucker" if k == "plucker_embedding" else k): fold(batch[k])
                   for k in moments + geometry}}

    def sanity_dump(batch):
        """First-step dumps of the raw batch (do_sanity_check,
        train_epi_control.py:503-510) and an epipolar overlay of the training
        pair from its F or H mats (:419-431): .npy always, GIF/PNG where
        imageio imports."""
        from cvd_tpu_torch.utils.video import have_imageio, save_videos_grid
        from cvd_tpu_torch.utils.visualize import check_fundamental

        sdir = os.path.join(out_dir, "sanity_check")
        os.makedirs(sdir, exist_ok=True)
        px = batch["pixel_values"]                          # [b, 2F, H, W, 3] in [-1, 1]
        mats = batch["F_mats"] if "F_mats" in batch else batch["H_mats"]
        mid = n_frames // 2
        overlay = check_fundamental(px[0, mid], px[0, n_frames + mid], mats[0, mid])
        np.save(os.path.join(sdir, "epi_overlay.npy"), overlay)
        if have_imageio():
            import imageio

            imageio.imwrite(os.path.join(sdir, "epi_overlay.png"), overlay)
            for i, text in enumerate(batch["text"]):
                name = "-".join(text.replace("/", "").split()[:10]) or f"0-{i}"
                save_videos_grid((px[i:i + 1] + 1) / 2, os.path.join(sdir, f"{name}.gif"))

    def endless(loader):
        while True:
            yield from loader

    iters = [(kind, endless(loader), weight) for kind, loader, weight in loaders]
    steps_per_epoch = max(1, len(loaders[0][1]))
    # an epoch is a pass over the first source: count its draws (from
    # global_step, so that a resumed run's epoch keeps growing)
    primary_draws = global_step
    losses, epi_losses, kinds, step_seconds = [], [], [], []
    val_every = cfg.get("validation_steps") or 0
    logger.info("training starts")
    try:
        while global_step < max_steps:
            t_data = time.perf_counter()
            kind, it, _ = iters[0]
            if len(iters) > 1:      # this step's (kind-homogeneous) source, by weight
                r, acc = sched_rng.random(), 0.0
                for kind, it, weight in iters:
                    acc += weight
                    if r < acc:
                        break
            primary_draws += it is iters[0][1]
            batch = next(it)
            texts = ["" if pyrng.random() < null_ratio else t for t in batch["text"]]
            if (cfg.get("do_sanity_check", True) and global_step == 0 and lead
                    and "pixel_values" in batch):   # cached-latents batches carry no pixels
                sanity_dump(batch)
            device_batch = fold_batch(batch, texts)
            t0 = time.perf_counter()
            m = program.step(device_batch, generator)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            epi_losses.append(m["epi_loss"])
            kinds.append(kind)
            global_step += 1
            if global_step % log_every == 0:
                logger.info(f"iter {global_step}/{max_steps} [{kind}] loss {m['loss']:.4f} "
                            f"epi {m['epi_loss']:.4f} data {t0 - t_data:.2f}s "
                            f"({loader_stats(loaders)}) iter {step_seconds[-1]:.2f}s "
                            f"ETA {format_time(step_seconds[-1] * (max_steps - global_step))}")
                metrics_log.log(global_step, loss=m["loss"], epi_loss=m["epi_loss"],
                                grad_norm=m["grad_norm"])
            if lead and val_every and global_step % val_every == 0:
                run_validation(modules, tokenizer, cfg, out_dir, global_step, logger)
            if lead and global_step % ckpt_every == 0:
                ck = os.path.join(out_dir, "checkpoints")
                save(os.path.join(ck, f"step-{global_step}.pt"), state, epoch)
                save_reference_ckpt(os.path.join(ck, f"checkpoint-step-{global_step}.ckpt"),
                                    state, epoch, global_step)
                logger.info(f"saved checkpoint at step {global_step}")
            epoch = primary_draws // steps_per_epoch
    finally:
        for _, it, _ in iters:
            it.close()      # ends each loader's epoch: its workers go
    logger.info("training done")
    return {"state": state, "modules": modules, "losses": losses, "epi_losses": epi_losses,
            "kinds": kinds, "step_seconds": step_seconds, "global_step": global_step,
            "epoch": epoch, "out_dir": out_dir, "latents_cache": cache, "rank": rank,
            "world_size": world, "program": program.stats}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel training over the processes torchrun starts")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(load_config(args.config), multihost=args.multihost)


if __name__ == "__main__":
    main()

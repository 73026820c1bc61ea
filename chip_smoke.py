#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cvd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --ckpt     (phases 1, 2, 4, 5, 8, 9, 10 and 12 only; prints no result, exit 4)
    python3 chip_smoke.py --mesh     (four cards: phases 1, 2 and ``mesh4``; prints no result, exit 5)

Phases (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions. No CUDA device -> exit 1, no result.
2. build: compiles every hand-written kernel from cvd_tpu_torch/csrc (nvcc,
   sm_90a, all sources at once) and the Triton GroupNorm, and prints the
   seconds taken.
3. kernels: each forward kernel against its plain PyTorch version at the
   2-view sampler's shapes, K2 with spatial extended attention's keys (Lk =
   2 Lq at res 32 and 16, timed), K1-K5 at multidiff's 12-frame windows (48
   frame rows, K3 at F 12), at the SDXL cell's (512 px, 64 frame rows: K1 at
   4096 / 1024 / 256 tokens a frame on a 512 px image's geometry, K2 with
   heads 64 wide, 10 at 1024 tokens and 20 at 256, K3 at 4096 and 256 tokens,
   GroupNorm at the UNet's and the VAE's slabs, K5 at res 64 / 32 / 16), at
   the N-view sampler's (128, 192 and 256 frame
   rows; K1 routed by a random perfect matching of 4 and of 6 views over
   interleaved CFG rows, and by the two offset groups of
   ``accumulate_batched``) and at the kernels' edges (64 tokens, head_dim 160, a
   ragged key length, a ragged token count; for K5 each case names its
   route (``kernel_route``), and the wide route is held at T 4104, K 1288,
   T 64, T 1024 and on a strided x at C 1280; for GroupNorm every kind of
   slab of the UNet, C/G off a power of two, the first-frame fusion blocks'
   (60 rows = 4 CFG rows x 15 frames: C 640 / 960 at S 1024, C 2560 / 3840
   at S 16, SiLU, eps 1e-6, timed), and which path each shape takes), and
   each backward kernel (K6, K7: autograd through the kernels
   against autograd of the plain versions) at the training shapes and at
   K6's edges (ragged lengths, 64 tokens, two query rows routed to one
   source row); K3 and K7 on contiguous q/k/v and on the ``split`` views of
   one fused projection that the motion module hands over (K7 also with a
   strided dO), and at ``TEMPORAL_EDGES``; all in f32 (TF32 off) and in
   bf16; max |error| against the
   stated tolerance, dq, dk and dv each against its own plain version. For
   the timed bf16 shapes, in turns inside the one call (CUDA events, after
   warm-up): the plain version, the kernels alone
   on prepared inputs and buffers (twice; K3 and K7, whose time is below the
   host's cost of a launch, from a replayed CUDA graph of 20 launches), one PyTorch library call for the
   same function as a yardstick (never used by the package), and the whole
   wrapper; beside them the roofline bound of the case from
   ``cvd_tpu_torch.ops.work`` (H100 SXM peaks).
4. reference: a narrow UNet (the smoke widths) at 256 px runs the sampler
   on the card, through the kernels, and on the CPU, through the plain
   versions, from the same weights and latents; final latents must agree
   at >= 60 dB SNR. The same for the 4-view sampler (2 steps, multistep 2,
   accumulate_step 2, pairings and re-noise drawn on the CPU from one
   seed), on the card as a loop of UNet calls and with
   ``accumulate_batched``. Then one train step of it, card against CPU, from the
   same weights, batch, noise, timesteps and slope (remat on): loss to
   1e-5 relative, trainable gradients at >= 60 dB SNR, and every trainable
   tensor with a nonzero gradient on the card. The narrow sampler with the
   image LoRA, the sync-LoRA and extended attention (K2 at Lk = 2 Lq), and
   with PAB reusing every class, card vs CPU at >= 60 dB. Last, the narrow model's
   weights written as checkpoint files in the released layouts and built by
   ``cli.build.build_modules`` on the card and on the CPU: the 2-view
   sampler at >= 60 dB again; then other weights loaded into the card's
   bundle must give, bit for bit, what a freshly built bundle gives (the
   LayerNorm-fold cache of K5 sees a load). Then this slice's modules,
   card vs CPU at >= 60 dB from drawn weights: a SparseCtrl model of each
   layout (every zero convolution nonzero) feeding its residuals into the
   UNet, and the UNet with ``fuse_first_frame``; and (with the train step
   above) one train step of the UNet with the auxiliary q/k head
   (``additional_channel`` 4, ``epi_loss_weight`` 1): loss and epi loss to
   1e-5 relative, gradients at >= 60 dB, the epi loss nonzero.
5. slice: ``cvd_tpu_torch.cli.inference`` at SD1.5 width (random weights,
   bf16, 256 px, 16 frames, 2 views, 3 DDIM steps) answers the two prompts
   of assets/example_prompts.json, its timesteps replayed as CUDA graphs
   (the samplers' default on the card; ``pipelines/program.py``). Launch
   counts are reset just before and read just after: every forward kernel
   must have run (the warm-up before the capture counts: it launches them).
6. nview: ``cvd_tpu_torch.cli.inference_advanced`` at SD1.5 width (random
   weights, bf16, 256 px, 16 frames, 4 views on the ``circle`` pattern, 3
   DDIM steps, multistep 2, accumulate_step 2, the first prompt): 10 UNet
   calls at 8 CFG rows, then the same with ``accumulate_batched`` (5 calls
   at 16 rows). Finite [4, 16, 256, 256, 3] videos, K1-K5 all launched, K1
   handed a route other than the 2-view half swap; ms per UNet call, s per
   request, peak memory and launches per call of both variants (captured,
   as phase 5).
7. train: ``cvd_tpu_torch.cli.train.run`` at SD1.5 width (bf16 frozen
   weights, f32 masters, 256 px, 16 frames, 1 folded pair, 4 steps, remat
   on, sanity dump on) on seeded pixels with the camera geometry of
   assets/pose_files, its steps replayed as one CUDA graph (the default on
   the card; ``train/program.py``): finite losses, trainable weights moved,
   frozen ones bit-identical, every kernel K1-K7 launched (the first step
   runs eagerly before the capture: its launches are the step's own, as in
   every training run below). Then
   one step with remat off for its peak memory. With ``--profile``,
   torch.profiler tables of three sampler UNet steps and of the N-view
   sampler's UNet calls at 8 and at 16 CFG rows (each eagerly and captured;
   kernel time by name, idle share;
   chiprun_out/{sampler_step,nview_8rows,nview_16rows}_{eager,captured}_profile.txt;
   the training step's: phase ``train_graphs`` (f)).

8. ckpt: the six checkpoint artifacts written at SD1.5 width from
   ``cvd_tpu_torch.io.manifests`` (seeded float16 values drawn on the card;
   SD folder with the UNet, the VAE under its legacy attention names and the
   text encoder, motion module, epi checkpoint, pose adaptor, and a rank-8
   motion LoRA) into a temporary directory, removed at the end.
   ``cli.build.validate_ckpts`` on the files; ``cli.inference.main`` from
   them (bf16, 256 px, 16 frames, 3 steps, the first prompt, the hash
   tokenizer): finite videos, K1-K5 launched as often per request as in
   phase 5. Every parameter of a second build equals its file's tensor cast
   to the parameter's dtype, bit for bit (LoRA targets: W + scale * up @
   down), every 4-D weight is still channels_last, and a bundle filled by
   ``load_state_dict`` from the same tensors gives the same latents bit for
   bit. Then ``cli.train.run`` from the files (remat on, 2 steps): finite
   losses, trainable tensors moved off and frozen ones equal to the files'
   values, K1-K7 launched, the f32 masters equal to the epi file before the
   first step. ``[ckpt]`` lines: seconds to write and to build per artifact,
   peak resident memory of the process, s/request, ms/UNet step, s/step,
   peak device memory.

9. options: from phase 8's files plus an image-LoRA file (CameraCtrl's keys
   under ``lora_state_dict``, rank channels // 2, every ``up`` nonzero) and an
   epi checkpoint carrying a sync-LoRA, float16 from the manifests: a 2-view
   request with the image LoRA, sync-LoRA rank 4 and spatial extended
   attention (K2 launched with keys of twice the queries' length); multidiff
   (``--video_length 12 --multidiff_total_steps 2 --multidiff_overlaps 8``,
   16 frames, 3 steps); the 2-view sampler at 10 steps and the 4-view sampler
   (5 steps, multistep 2, accumulate_step 2) each without and with ``--pab``
   (default ranges): launches per UNet call on computing and on reuse steps,
   none of a reused class's own kernel (K2 spatial, K3 temporal, K1 epi) on
   its reuse steps; then two training steps with both LoRAs (remat on):
   finite losses, the sync-LoRA moved, the image LoRA bit-identical to its
   file. Each path: launches counted from 0, s/request, ms per UNet call,
   peak memory.

10. extras: from phase 8's files plus a SparseCtrl file of each layout
   (float16 from ``animatediff_sparsectrl_manifest``, every zero convolution
   nonzero; the pyramid at the file's top level, the simplified one under
   ``state_dict``): (a) ``build_modules`` with ``--controlnet_ckpt`` for each:
   every SparseCtrl parameter equal to its file's tensor cast to bf16, one
   SparseCtrl call at 4 CFG rows x 16 frames (K2 / K3 / K4 / K5 launches and
   ms per call), then the UNet with its residuals: finite, and unlike the
   UNet without them; (b) one UNet call with ``fuse_first_frame`` at SD1.5
   width: finite, K4 launched at the fusion blocks' shapes; (c)
   ``cli.train.run`` from the files with ``cache_latents`` (2 items of the
   seeded pairs of phase 7, built once), the auxiliary head (a copy of
   configs/inference_config.yaml with ``additional_channel`` 64),
   ``epi_loss_weight`` 0.002 and validation every 2 steps (3 DDIM steps on
   assets/pose_files), 4 steps, remat on: finite losses and epi losses, the
   head's convolutions moved, validation files written, K1-K7 launched; s/step
   beside the same run's without the cache and validation (just before it)
   and phase 7's (no cache, no head), the cache's seconds per item, the peak
   memory.

11. training: (a) one unposed training step of the narrow UNet (H mats of a
   random homography, one slope per row, warped masks, an image LoRA at
   scale 0) at 256 px, remat on, card vs CPU from the same weights, batch,
   noise, timesteps and slopes: loss to 1e-5 relative, trainable gradients
   at >= 60 dB, none zero on the card, K1-K7 launched; (b)
   ``cli.train.run`` on hybrid data (posed_ratio 0.5: phase 7's seeded
   pairs and seeded frames made into pseudo-pairs by
   ``data.webvid.homography_pair``) at SD1.5 width, bf16 frozen, 256 px, 16
   frames, 4 steps, remat on, ``worker_type: process`` with 2 workers:
   finite losses, both kinds drawn (two graphs captured), K1 and K6
   launched on the unposed steps, frozen weights bit-identical to a fresh
   build's, trainable ones moved; s/step and launches per step of each
   kind; (c) with that model, one gradient computation (no update) on one
   posed batch for remat off,
   ``block`` with ``""``, ``dots``, ``dots_no_batch`` and ``dots_small``, and
   ``layer`` with ``""``: peak memory, s/step, launches per step, gradients
   at >= 60 dB against ``block ""``; (d) two steps of ``run`` at (b)'s size
   (SD1.5 width, bf16 frozen, 256 px, 16 frames, remat on) with
   ``multihost`` as a world of one over NCCL: the losses bit for bit those of
   the same run without it (eager, ``capture=False``: a run under a process
   group is not captured), the peak memory of each, the process group
   destroyed, the multihost steps not captured.

12. civitai: from phase 8's files, at SD1.5 width, bf16, 256 px, 16 frames:
   (a) a civitai single-file model written from the LDM manifests
   (``ldm_sd15_{unet,vae,clip}_manifest``, float16 from a seed of its own,
   ``torch.save``d under ``state_dict``) and a kohya LoRA (rank 8, ``.alpha``
   entries, every spatial attention projection, ``proj_in`` / ``proj_out`` as
   1x1 convolutions and ``ff``, and the text encoder's ``lora_te_*``
   projections); (b) ``build_modules`` with ``--civitai_base_model`` and
   ``--civitai_lora_ckpt``: every spatial UNet, VAE and text-encoder tensor
   equal to the file's cast to bf16, the LoRA's targets to W + 0.6 * (alpha /
   r) * up @ down, the text encoder not fused, the motion, epi and pose
   tensors bit-identical to a build without the civitai files; (c)
   ``cli.inference.main`` with both options, one request of 10 steps, and
   again with ``--pab``: both saved as ``.npy`` and compared by
   ``cli.eval_parity --json`` (mean and min PSNR: with random weights, PAB's
   drift, not quality); (d) ``schedulers.inversion.ddim_invert`` of that
   request's final latents through the UNet (the conditional rows) and a
   sampling from the inverted noise: the round trip's error, everything
   finite; (g) ``utils.profiling.trace`` over one UNet call at 4 CFG rows:
   the port's kernels summed from the trace file; (e) two steps of
   ``cli.train.run`` with the ``civitai_*`` keys: finite losses, trainable
   tensors moved, frozen ones the civitai file's; (f)
   ``utils.flops.unet_apply_flops(4, 16, 32)`` over phase 5's median UNet
   step, as achieved TFLOP/s beside the card's name and power limit. K1-K5
   launched on (c) and (d), K1-K7 on (e), each path counted from 0.

train_graphs (after phase 11; ``[train_graphs]`` lines): the training step
   replayed as CUDA graphs (``train/program.py``) against eager steps, at
   SD1.5 width, bf16 frozen, f32 masters, 256 px, 16 frames, three bundles
   of one seed (two eager runs, whose difference is eager's own spread, and
   a captured one) stepping in lockstep on the same batches from generators
   of one seed (AdamW, cosine schedule): (a) 4 steps of each of posed
   (pixels), unposed (pseudo-pairs), hybrid (posed_ratio 0.5) and the latents
   cache (posterior moments), with remat off and then ``block ""`` (the runs
   go on from kind to kind: 32 steps; one program per run and setting, so
   the hybrid steps replay the posed and unposed graphs): loss, grad norm
   and trainable weights after every step differ from the first eager run's
   by no more than the second eager run's (0: bit for bit); (b) K1-K7
   launches over the steps equal, captured and eager; (c) (posed, remat off)
   validation sampling after steps 2 and 4 of each run: the captured run's
   videos within the eager runs' spread (K5's fold cache sees the replays'
   writes); (d) (posed, remat off) ``save`` at step 2, ``restore`` into the
   captured run after step 4, steps 3 and 4 replayed again: within the
   spread of the unbroken eager run, no capture again; (e) s/step captured
   and eager per kind and remat setting (off and ``block ""`` from (a)'s
   lockstep; ``layer ""`` and ``block dots`` per kind, ``block
   dots_no_batch`` and ``block dots_small`` posed, in turns: eager, captured,
   captured, eager), the first step's seconds and its capture's, an eager
   step's peak allocated memory above what was resident beside the graph's
   pool (reserved: a replay allocates nothing);
   (f) with ``--profile``: torch.profiler over one captured and one eager
   remat-on (``block ""``) posed step, the idle share of each
   (chiprun_out/train_step_{eager,captured}_profile.txt); (g) two f32 steps
   (TF32 off) of the SD1.5-wide model, every tensor drawn, 2 x 4 frames at
   64 px, remat off, on the card through the graphs (the first eager before
   the capture, the second replayed) against the same steps on the CPU from
   the same weights and pinned draws: the replayed step's loss to 1e-5
   relative, its clipped gradients and the updated weights at >= 60 dB.

graphs (after phase 6): the samplers' timesteps as replayed CUDA graphs
   against the same requests run eagerly (``capture=False``), at SD1.5 width,
   bf16, 256 px, 16 frames: (a) phase 5's two requests eagerly, videos bit
   for bit phase 5's; (b) phase 6's 4-view request eagerly as a loop and
   batched, videos bit for bit phase 6's; (c) the 4-view request with
   ``--step_chunk`` 1, 2 and 3 (3 timesteps: the last its own graph, a
   ragged chunk at 2): videos bit for bit each other's; (d) the epi slopes,
   pairings and noises of (b)'s eager loop and (c)'s step_chunk 1, recorded
   on the card at every draw (a graph's replays record theirs): equal draw
   for draw, and no slope drawn twice (a graph that replayed its first
   draws would repeat them); (e) launches per UNet call of the denoising
   loop, captured (phases 5 and 6) against eager ((a), (b)): equal for
   K1-K5; (f) at the pipelines, from one build, in turns: captured and eager
   requests at 4, 8 and 16 CFG rows (2 views, 4 views as a loop and
   batched): s a request, median ms a UNet call, the first request's
   capture seconds, peak allocated and reserved memory (``[graphs]``
   lines; with ``--profile``, the idle share of captured and eager steps).

mesh (after phase graphs): (a) K1 and K3 at the shapes a rank of a sharded
   sampler hands them, against their plain versions in f32 (TF32 off) and
   bf16 with phase 3's limits, timed in bf16 beside the unsharded shapes:
   K1 with k/v gathered over the rows (2x and 4x the query rows) and the
   half swap's or a random 4-view matching's route remapped to the
   gathered block, K3 with 4 and 8 query frames of a frames shard against
   16 key frames, without a mask and with the causal mask's rows of the
   shard; (b) ``cli.inference --sharded`` and (c) ``cli.inference_advanced
   --sharded`` (as a loop and batched) as a world of one over NCCL at the
   sizes of phases 5 and 6 (eagerly: ``--sharded`` is not captured):
   videos bit for bit those of phases 5 and 6 (captured),
   every forward kernel launched, launches per UNet call; ``[mesh]`` lines.

mesh4 (``--mesh`` only; raises below 4 cards): ``torch.distributed.run``
   starts four processes of this script (``--mesh-worker``), NCCL over the
   four cards. The narrow model (f32, TF32 off, every tensor drawn, 256
   px, 4 frames, 2 steps) on the meshes (4, 1), (2, 2) and (1, 4): the
   2-view sampler and the 4-view sampler with fix_firstframe as a loop and
   batched, each >= 60 dB against one card and bit-equal on the ranks;
   then both CLIs at SD1.5 width (bf16) with ``--sharded`` on their own
   mesh (4, 1), against the same requests on one card: s a request, ms a
   UNet call (the first apart), peak GiB per card, PSNR (``[mesh4]``
   lines; PSNR reported, not a gate).

The second-to-last line is the per-kernel JSON record (times, bound,
library yardstick, launches summed over the main paths and per UNet step or
call of each sampler and per training step, and each path of phases 9, 10,
11, 12, train_graphs and mesh; K1 and K3 also carry phase mesh's timings); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_F32 = 1e-4   # f32 in, f32 products: summation order only
TOL_BF16 = 2e-2  # bf16 in: rounding points differ (P, outputs), ~2^-7 per rounding
KERNELS = {
    # name: (route, source, TPU kernel body replaced: _fwd_kernel, _gn_kernel,
    # _ln_mm_kernel, _bwd_kernel; K1/K2 and K6 are has_bias=True / False)
    "epi_flash_attention": ("cuda", "cvd_tpu_torch/csrc/epi_flash_fwd.cu",
                            "cvd_tpu/ops/epi_flash.py:75"),
    "flash_attention": ("cuda", "cvd_tpu_torch/csrc/epi_flash_fwd.cu",
                        "cvd_tpu/ops/epi_flash.py:75"),
    "temporal_flash_attention": ("cuda", "cvd_tpu_torch/csrc/temporal_attn_fwd.cu",
                                 "cvd_tpu/ops/temporal_attn.py:42"),
    "group_norm": ("triton", "cvd_tpu_torch/ops/norms.py",
                   "cvd_tpu/ops/norms.py:44"),
    "layer_norm_matmul": ("cuda", "cvd_tpu_torch/csrc/ln_matmul_fwd.cu",
                          "cvd_tpu/ops/ln_matmul.py:48"),
    "epi_flash_attention_bwd": ("cuda", "cvd_tpu_torch/csrc/epi_flash_bwd.cu",
                                "cvd_tpu/ops/epi_flash.py:113"),
    "flash_attention_bwd": ("cuda", "cvd_tpu_torch/csrc/epi_flash_bwd.cu",
                            "cvd_tpu/ops/epi_flash.py:113"),
    "temporal_flash_attention_bwd": ("cuda", "cvd_tpu_torch/csrc/temporal_attn_bwd.cu",
                                     "cvd_tpu/ops/temporal_attn.py:77"),
}
# device-kernel name stems of the port's kernels, for the profile's sums
PORT_KERNELS = ("epi_flash_fwd_bf16", "ln_matmul_bf16", "temporal_attn_fwd_mma",
                "temporal_attn_bwd_mma", "temporal_attn_fwd_kernel", "temporal_attn_bwd_kernel",
                "epi_flash_bwd_dkdv", "epi_flash_bwd_dq", "epi_flash_bwd_delta", "_gn_one_pass",
                "_gn_partial", "_gn_finalize", "_gn_apply")
FORWARD = ("epi_flash_attention", "flash_attention", "temporal_flash_attention",
           "group_norm", "layer_norm_matmul")
# K3 / K7 off the main path, (B, N, F, G, C, heads, mask, q/k/v as split views):
# frames below the 16-row tile of the bf16 kernels and ragged against each
# other, frames above it and a head_dim of 24 (the route to the f32-product
# kernels), head_dim 8 and 16 (the smoke widths, 4 heads) and 160, the causal
# mask, the "0" mask (one allowed key a row) and an arbitrary one
TEMPORAL_EDGES = (
    (2, 128, 12, 12, 320, 8, None, True), (2, 128, 12, 12, 320, 8, "causal", False),
    (2, 128, 16, 9, 320, 8, None, False), (2, 128, 7, 16, 320, 8, "random", False),
    (2, 128, 16, 24, 320, 8, "random", False), (2, 128, 24, 24, 320, 8, "causal", True),
    (3, 130, 16, 16, 192, 8, None, False),
    (2, 256, 16, 16, 32, 4, None, True), (2, 256, 16, 16, 64, 4, "causal", True),
    (2, 64, 16, 16, 1280, 8, None, True),
    (2, 256, 16, 16, 320, 8, "causal", True), (2, 128, 16, 16, 320, 8, "0", True),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi[0]


def phase_build(torch):
    from cvd_tpu_torch.ops import _build
    from cvd_tpu_torch.ops.norms import group_norm

    t0 = time.perf_counter()
    _build.build(["epi_flash_fwd", "epi_flash_bwd", "temporal_attn_fwd",
                  "temporal_attn_bwd", "ln_matmul_fwd"])
    t_nvcc = time.perf_counter() - t0
    # Triton compiles at first launch: one small GroupNorm per dtype / act on
    # each path (a slab that fits a block, a row that needs the split)
    for dtype in (torch.float32, torch.bfloat16):
        for act in (None, "silu"):
            for S, C in ((64, 64), (8192, 256)):
                x = torch.randn(2, S, C, device="cuda", dtype=dtype)
                group_norm(x, torch.ones(C, device="cuda"), torch.zeros(C, device="cuda"),
                           32, act=act)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[build] nvcc {t_nvcc:.1f} s, total {t_build:.1f} s")
    return t_nvcc, t_build


def _time_ms(torch, fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_captured_ms(torch, fn, iters=20):
    """The device time of ``fn``: ``iters`` calls captured into one CUDA graph
    and replayed between two events, so that the host's cost of a launch,
    which exceeds the time of the smallest kernels (K3, K7), stays out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(torch, graph.replay, iters=1) / iters


def _case(name, label, kernel, plain, timed=False, **timing):
    """One comparison of phase 3. ``kernel`` / ``plain``: the wrapper and its
    plain version on the same inputs. For a timed case ``timing`` holds
    factories, called only in bf16, each -> the function to time:
    ``launch`` the kernel alone on prepared inputs (default: the wrapper),
    timed from a replayed CUDA graph where ``captured`` is set;
    ``wrapper``, not a factory, the public function where ``kernel`` does
    more than call it;
    ``plain_timer`` (default: ``plain``), ``library`` the PyTorch yardstick
    named by ``library_call``; and ``work`` = (flops, bytes, the type the
    operations run in) of the case."""
    return dict(name=name, label=label, kernel=kernel, plain=plain, timed=timed, **timing)


def _heads(x, heads):
    """[B, L, C] -> [B, heads, L, D], the layout of scaled_dot_product_attention."""
    B, L, C = x.shape
    return x.reshape(B, L, heads, C // heads).transpose(1, 2)


def _layout(split):
    return "split views" if split else "contiguous"


def _temporal_inputs(randn, B, N, Fr, G, C, split, grad=False):
    """q [B, N, Fr, C], k, v [B, N, G, C] (and, with ``grad``, dO like q) from
    ``randn(*shape)``: contiguous tensors or, with ``split``, what the motion
    module hands over: three views of one fused [B, N, Fr, 3C] projection
    (and dO a view of a wider tensor)."""
    if split:
        qkv = list(randn(B, N, Fr, 3 * C).split(C, -1))
    else:
        qkv = [randn(B, N, Fr, C), randn(B, N, G, C), randn(B, N, G, C)]
    if grad:
        qkv.append(randn(B, N, Fr, 2 * C)[..., C:] if split else randn(B, N, Fr, C))
    return qkv


def _temporal_mask(torch, g, kind, Fr, G):
    """None, a mask of ``causal_temporal_mask`` ("causal", "0") or, for
    "random", an arbitrary finite [Fr, G] mask."""
    from cvd_tpu_torch.models.motion import causal_temporal_mask

    if kind is None:
        return None
    if kind == "random":
        return torch.randn(Fr, G, generator=g, device="cuda")
    return causal_temporal_mask(kind, Fr).to("cuda")


def _epi_inputs(torch, g, B, feat, route=None, size=256):
    """The epipolar geometry and routing (default: the 2-view half swap) of B
    frame rows at a feat x feat grid of a size x size image."""
    from cvd_tpu_torch.geometry.epipolar_mask import (
        epipolar_lines, lines_and_band, pixel_grid_coords,
    )

    F_mats = torch.randn(B, 3, 3, generator=g, device="cuda") * 1e-3
    coords = pixel_grid_coords(feat, size, "cuda")
    lines, band, alpha = lines_and_band(epipolar_lines(F_mats, coords), feat, size)
    if route is None:
        route = torch.cat([torch.arange(B // 2, B), torch.arange(0, B // 2)])
    return (lines, coords[:, :2].T.contiguous(), band, alpha), route.to("cuda", torch.int32)


def _plain_by_rows(torch, epi_flash, q, k, v, geom, route, heads, rows=8):
    """``epi_flash._plain`` over blocks of ``rows`` query rows (k / v whole,
    read through the route): the same numbers without the whole call's
    [B, heads, N, N] logits at once (34 GB in f32 at 64 rows of 4096 tokens)."""
    lines, coords, band, alpha = geom
    return torch.cat([epi_flash._plain(q[i:i + rows], k, v,
                                       (lines[i:i + rows], coords, band[i:i + rows],
                                        alpha[i:i + rows]), route[i:i + rows], heads)
                      for i in range(0, q.shape[0], rows)])


def _nview_route(torch, g, views, groups, frames=16):
    """kv_index as ``AdvancedPipeline`` builds it: a random perfect matching
    of the views over interleaved CFG rows (2 * views * frames rows), and for
    ``accumulate_batched`` one matching a group, each offset into its own
    row block."""
    from cvd_tpu_torch.pipelines.advanced import partner_rows, random_pairing

    rows = 2 * views * frames
    return torch.cat([partner_rows(random_pairing(g, views), frames) + i * rows
                      for i in range(groups)])


def _block_route(torch, route, shape, rank, videos, frames=16):
    """The global route of ``videos`` x ``frames`` rows as rank ``rank`` of a
    ("rows", "frames") mesh of ``shape`` hands it to K1: its block rows'
    partners as positions in the rows-gathered block."""
    from cvd_tpu_torch.parallel.mesh import Mesh
    from cvd_tpu_torch.parallel.shard_ops import local_route

    R, Cf = shape
    mesh = Mesh(("rows", "frames"), {"rows": R, "frames": Cf},
                {"rows": rank // Cf, "frames": rank % Cf}, rank, torch.device("cuda"), {})
    return local_route(route.to("cuda"), mesh, videos // R, frames // Cf)


def _cases(torch, dtype, g, mesh=False):
    """The comparisons at the main-path shapes (256 px, 16 frames, 2 views =
    4 CFG rows) and at the kernels' edges; with ``mesh``, K1 and K3 at the
    shapes a rank of a sharded sampler hands them (phase ``mesh``)."""
    import torch.nn.functional as F

    from cvd_tpu_torch.ops import epi_flash, ln_matmul, norms, temporal_attn, work

    dev = "cuda"
    size = torch.empty((), dtype=dtype).element_size()
    sdpa = F.scaled_dot_product_attention

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale + shift).to(dtype)

    def epi_launch(q, k, v, geom, route, heads=8):
        prep = epi_flash._prepare(q, k, v, geom, route, heads)
        return lambda: epi_flash._launch(*prep, heads)

    def epi_library(q, k, v, geom, route, heads=8):
        # outside the timed call: the [B, 1, N, N] bias and the routed k / v
        qh = _heads(q, heads)
        kh, vh = ((_heads(x, heads) if route is None else _heads(x[route.long()], heads))
                  for x in (k, v))
        mask = None if geom is None else epi_flash.bias_from_geometry(*geom)[:, None].to(q.dtype)
        return lambda: sdpa(qh, kh, vh, attn_mask=mask)

    def temporal_case(label, xs, mask, heads, timed=False):
        def launch():
            prep = temporal_attn._prepare(*xs, mask, heads)
            return lambda: temporal_attn._launch(*prep, heads)

        def library():
            qh, kh, vh = (_heads(x.reshape(-1, x.shape[2], x.shape[-1]), heads) for x in xs)
            return lambda: sdpa(qh, kh, vh, attn_mask=mask)

        B, N, Fr, C = xs[0].shape
        return _case(
            "temporal_flash_attention", label,
            lambda: temporal_attn.temporal_flash_attention(*xs, mask, heads=heads),
            lambda: temporal_attn.temporal_attention_plain(*xs, mask, heads), timed,
            launch=launch, captured=True, library=library,
            library_call="scaled_dot_product_attention on [B*N, h, F, D]",
            work=(*work.temporal_fwd(B, N, Fr, C, size, mask is not None), str(dtype)[6:]))

    def attention_cases(B, feat, C, route, what, timed):
        """K1 (bias, routed by ``route``; None: the half swap) and K2 on B frame
        rows of a feat x feat grid."""
        N, D = feat * feat, C // 8
        q, k, v = randn(B, N, C), randn(B, N, C), randn(B, N, C)
        geom, route = _epi_inputs(torch, g, B, feat, route)
        return [_case(
            "epi_flash_attention", f"B{B} N{N} C{C} h8 {what}",
            lambda: epi_flash.epi_flash_attention(q, k, v, *geom, heads=8, kv_index=route),
            lambda: epi_flash._plain(q, k, v, geom, route, 8), timed,
            launch=lambda: epi_launch(q, k, v, geom, route),
            library=lambda: epi_library(q, k, v, geom, route),
            library_call="scaled_dot_product_attention, attn_mask = the bias; excludes "
                         "materialising the bias and gathering k/v by kv_index",
            work=(*work.attention_fwd(B, 8, N, N, D, size, True, True), "bfloat16")), _case(
            "flash_attention", f"B{B} N{N} C{C} h8",
            lambda: epi_flash.flash_attention(q, k, v, heads=8),
            lambda: epi_flash._plain(q, k, v, None, None, 8), timed,
            launch=lambda: epi_launch(q, k, v, None, None),
            library=lambda: epi_library(q, k, v, None, None),
            library_call="scaled_dot_product_attention",
            work=(*work.attention_fwd(B, 8, N, N, D, size), "bfloat16"))]

    if mesh:
        return _mesh_cases(torch, g, randn, epi_launch, epi_library, temporal_case, size)
    cases = []
    for feat, C in ((32, 320), (16, 640), (8, 1280)):
        N = feat * feat
        # res 16 timed too: extended attention's res-16 case beside it
        cases += attention_cases(64, feat, C, None, "routed", feat in (32, 16))
        if feat == 8:
            continue  # the temporal kernel's shapes stay those of the main path
        for split in (True, False):  # the main path's layout first: the record's row
            cases.append(temporal_case(f"B4 N{N} F16 C{C} h8 {_layout(split)}",
                                       _temporal_inputs(randn, 4, N, 16, 16, C, split), None, 8,
                                       feat == 32))
    # CVD on the SDXL backbone at 512 px, 16 frames, 2 views (64 frame rows): the
    # epi modules' 8 heads at 4096 / 1024 / 256 tokens a frame on a 512 px image's
    # geometry (the plain version in blocks of rows), the spatial attentions' heads
    # 64 wide (10 at 1024 tokens, 20 at 256), the motion modules at 4096 and 256
    for feat, C in ((64, 320), (32, 640), (16, 1280)):
        N = feat * feat
        q, k, v = randn(64, N, C), randn(64, N, C), randn(64, N, C)
        geom, route = _epi_inputs(torch, g, 64, feat, size=512)
        cases.append(_case(
            "epi_flash_attention", f"B64 N{N} C{C} h8 routed, 512 px (SDXL)",
            lambda q=q, k=k, v=v, geom=geom, route=route:
            epi_flash.epi_flash_attention(q, k, v, *geom, heads=8, kv_index=route),
            lambda q=q, k=k, v=v, geom=geom, route=route:
            _plain_by_rows(torch, epi_flash, q, k, v, geom, route, 8)))
    for N, C, h in ((1024, 640, 10), (256, 1280, 20)):
        q, k, v = randn(64, N, C), randn(64, N, C), randn(64, N, C)
        cases.append(_case(
            "flash_attention", f"B64 N{N} C{C} h{h} (SDXL)",
            lambda q=q, k=k, v=v, h=h: epi_flash.flash_attention(q, k, v, heads=h),
            lambda q=q, k=k, v=v, h=h: epi_flash._plain(q, k, v, None, None, h), True,
            launch=lambda q=q, k=k, v=v, h=h: epi_launch(q, k, v, None, None, h),
            library=lambda q=q, k=k, v=v, h=h: epi_library(q, k, v, None, None, h),
            library_call="scaled_dot_product_attention",
            work=(*work.attention_fwd(64, h, N, N, C // h, size), "bfloat16")))
    for N, C in ((4096, 320), (256, 1280)):
        cases.append(temporal_case(f"B4 N{N} F16 C{C} h8 {_layout(True)} (SDXL)",
                                   _temporal_inputs(randn, 4, N, 16, 16, C, True), None, 8))
    # the N-view sampler's rows: V views x 2 CFG rows x 16 frames, routed by a
    # random perfect matching of the views; with accumulate_batched, 2 groups
    for views, groups, feat, C, timed in ((4, 1, 32, 320, True), (4, 1, 16, 640, False),
                                          (4, 1, 8, 1280, False), (6, 1, 32, 320, False),
                                          (4, 2, 32, 320, True)):
        what = f"matching of {views} views" + (f" x{groups} groups" if groups > 1 else "")
        cases += attention_cases(2 * views * 16 * groups, feat, C,
                                 _nview_route(torch, g, views, groups), what, timed)
    for B in (8, 16):
        cases.append(temporal_case(f"B{B} N1024 F16 C320 h8 {_layout(True)}",
                                   _temporal_inputs(randn, B, 1024, 16, 16, 320, True), None, 8,
                                   True))
    for B, N, Fr, G, C, h, kind, split in TEMPORAL_EDGES:
        cases.append(temporal_case(
            f"B{B} N{N} F{Fr} G{G} C{C} h{h} {kind or 'no'} mask {_layout(split)}",
            _temporal_inputs(randn, B, N, Fr, G, C, split),
            _temporal_mask(torch, g, kind, Fr, G), h))
    # spatial extended attention: the pair's tokens as keys and values, Lk = 2 Lq
    for feat, C in ((32, 320), (16, 640)):
        N = feat * feat
        q, k, v = randn(64, N, C), randn(64, 2 * N, C), randn(64, 2 * N, C)
        cases.append(_case(
            "flash_attention", f"B64 Lq{N} Lk{2 * N} C{C} h8 extended",
            lambda q=q, k=k, v=v: epi_flash.flash_attention(q, k, v, heads=8),
            lambda q=q, k=k, v=v: epi_flash._plain(q, k, v, None, None, 8), True,
            launch=lambda q=q, k=k, v=v: epi_launch(q, k, v, None, None),
            library=lambda q=q, k=k, v=v: epi_library(q, k, v, None, None),
            library_call="scaled_dot_product_attention",
            work=(*work.attention_fwd(64, 8, N, 2 * N, C // 8, size), "bfloat16")))
    # multidiff's 12-frame windows: 2 views x 2 CFG rows x 12 frames = 48 frame rows,
    # K3 at F 12, below the 16-row tile
    for feat, C in ((32, 320), (16, 640)):
        N = feat * feat
        cases += attention_cases(48, feat, C, None, "routed, 12-frame window", False)
        cases.append(temporal_case(f"B4 N{N} F12 C{C} h8 {_layout(True)}",
                                   _temporal_inputs(randn, 4, N, 12, 12, C, True), None, 8))
    # a ragged key length and a query length that fills no tile
    q, k, v = randn(4, 200, 320), randn(4, 150, 320), randn(4, 150, 320)
    cases.append(_case("flash_attention", "B4 Lq200 Lk150 C320 h8 ragged",
                       lambda q=q, k=k, v=v: epi_flash.flash_attention(q, k, v, heads=8),
                       lambda q=q, k=k, v=v: epi_flash._plain(q, k, v, None, None, 8)))
    sms = norms._sm_count(torch.device("cuda", 0))
    # the UNet's slabs (res 32 in, res 32 / 16 / 8 up-path concatenations), a
    # C/G off a power of two with S off the block, and the VAE's full-size rows
    # ... and the N-view sampler's 128 and 256 frame rows
    # ... and the first-frame fusion blocks' (4 CFG rows x 15 frames): concat(first,
    # frame) over 2C then 3C channels, C 320 at res 32 and 1280 at res 4
    for R, S, C, timed in ((64, 1024, 320, True), (64, 1024, 960, False), (64, 256, 1920, False),
                           (64, 64, 2560, False), (5, 200, 1344, False), (32, 65536, 128, True),
                           (128, 1024, 320, True), (256, 1024, 320, True),
                           (48, 1024, 320, False), (60, 1024, 640, True), (60, 1024, 960, True),
                           (60, 16, 2560, True), (60, 16, 3840, True),
                           # SDXL at 512 px: the UNet's slabs (res 64 / 32 / 16, the
                           # up path's concatenations) and the VAE's at 128 / 256 / 512
                           (64, 4096, 320, False), (64, 4096, 640, False),
                           (64, 4096, 960, False), (64, 1024, 1280, False),
                           (64, 1024, 1920, False), (64, 256, 1280, False),
                           (64, 256, 2560, False), (32, 65536, 512, False),
                           (32, 262144, 256, False), (32, 262144, 128, False)):
        x = randn(R, S, C, scale=2.0, shift=3.0)
        gam, bet = randn(C, scale=0.5, shift=1.0), randn(C, scale=0.1)
        p = norms.plan(R, S, C, 32, size, sms)
        path = f"one pass x{p.bundle}" if p.one_pass else f"split x{p.nsplit}"

        def gn_library(x=x, gam=gam, bet=bet):
            xc = x.transpose(1, 2).contiguous()  # [R, C, S], as F.group_norm reads it
            return lambda: F.silu(F.group_norm(xc, 32, gam, bet, 1e-6))

        def gn_launch(x=x, gam=gam, bet=bet, p=p):
            y = torch.empty_like(x)  # the one-pass kernel alone; the split path is 3 launches
            return lambda: norms._launch_one_pass(x, y, gam, bet, 32, 1e-6, "silu", p)

        for act in ("silu", None):
            cases.append(_case(
                "group_norm", f"R{R} S{S} C{C} {act or 'no act'} [{path}]",
                lambda x=x, gam=gam, bet=bet, act=act:
                norms.group_norm(x, gam, bet, 32, 1e-6, act=act),
                lambda x=x, gam=gam, bet=bet, act=act:
                norms._reference(x, gam, bet, 32, 1e-6, act), timed and act == "silu",
                launch=gn_launch if p.one_pass else None, library=gn_library, library_call="2 calls: group_norm + silu on [R, C, S]",
                work=(*work.group_norm(R, S, C, size), "float32")))
    # T = 131072 and 262144 tokens: the N-view sampler's 128 and 256 frame rows at res 32
    for T, C, Ks, *strided in (
            (65536, 320, (2560,)), (65536, 320, (320, 320, 320)), (16384, 640, (5120,)),
            (4096, 1280, (1280, 1280, 1280)), (1000, 320, (320, 320, 320)),
            (131072, 320, (2560,)), (262144, 320, (2560,)),
            (8192, 1280, (1280, 1280, 1280)), (49152, 320, (2560,)),
            # SDXL at 512 px: the motion / epi modules at res 64, the
            # transformers at res 32 and 16
            (262144, 320, (320, 320, 320)), (65536, 640, (640, 640, 640)),
            (16384, 1280, (1280, 1280, 1280)), (16384, 1280, (10240,)),
            (16384, 1280, (1280,)), (65536, 640, (5120,)),
            # the wide route's edges: T off the 128-row tile, K off the
            # 256-column tile, one row of tiles, few tokens, a row stride > C
            (4104, 1280, (3840,)), (4096, 1280, (1288,)),
            (64, 1280, (1280, 1280, 1280)), (1024, 1280, (10240,)),
            (4104, 1280, (1280, 1280, 1280), "strided")):
        # strided: the tokens as a view of wider rows (row stride 2C), uncopied by the wrapper
        x = randn(T, 2 * C)[:, C:] if strided else randn(T, C)
        gam, bet = randn(C, scale=0.5, shift=1.0), randn(C, scale=0.1)
        ws = [randn(K, C, scale=1.0 / math.sqrt(C)) for K in Ks]
        bs = [None] * len(Ks) if len(Ks) > 1 else [randn(Ks[0], scale=0.1)]

        def lnmm_launch(x=x, gam=gam, bet=bet, ws=ws, bs=bs):
            w_f, b_f = ln_matmul.fold_weights(gam, bet, ws, bs, x.dtype)
            return lambda: ln_matmul._launch(x, w_f, b_f, 1e-5)

        def lnmm_library(x=x, gam=gam, bet=bet, ws=ws, bs=bs):
            w_all = torch.cat(ws)
            b_all = None if bs[0] is None else torch.cat(bs)
            return lambda: F.linear(F.layer_norm(x, (x.shape[-1],), gam, bet, 1e-5), w_all, b_all)

        route = ln_matmul.kernel_route(T, C, sum(Ks), str(dtype)[6:])
        cases.append(_case(
            "layer_norm_matmul", f"T{T} C{C} K{sum(Ks)}{' strided x' if strided else ''} [{route}]",
            lambda x=x, gam=gam, bet=bet, ws=ws, bs=bs:
            torch.cat(ln_matmul.layer_norm_matmul(x, gam, bet, ws, bs), -1),
            lambda x=x, gam=gam, bet=bet, ws=ws, bs=bs:
            ln_matmul._reference(x, gam, bet, ws, bs, 1e-5), T >= 65536,
            launch=lnmm_launch, library=lnmm_library,
            wrapper=lambda x=x, gam=gam, bet=bet, ws=ws, bs=bs:
            ln_matmul.layer_norm_matmul(x, gam, bet, ws, bs),
            library_call="2 calls: layer_norm + linear",
            work=(*work.ln_matmul(T, C, sum(Ks), size), "bfloat16")))
    return cases + _bwd_cases(torch, dtype, g)


def _mesh_cases(torch, g, randn, epi_launch, epi_library, temporal_case, size):
    """K1 and K3 as a rank of a sharded sampler runs them at SD1.5 width (256
    px, 16 frames, res 32): K1 on its block's query rows against k/v
    gathered over the rows (2x and 4x the queries), routed by the remapped
    half swap (2 views, 4 CFG rows) and a random matching of 4 views (8 CFG
    rows); K3 with 4 and 8 query frames of a frames shard against all 16 key
    frames, without a mask and with the causal mask's rows of the shard. The
    unsharded shapes beside them, timed in the same turns."""
    from cvd_tpu_torch.models.motion import causal_temporal_mask
    from cvd_tpu_torch.ops import epi_flash, work

    feat, C, Fr = 32, 320, 16
    N = feat * feat
    half_swap = (torch.arange(4 * Fr) + 2 * Fr) % (4 * Fr)
    matching = _nview_route(torch, g, 4, 1, Fr)
    cases = []
    for what, route, videos, shape, rank, timed in (
            ("half swap", half_swap, 4, (1, 1), 0, True),
            ("half swap", half_swap, 4, (2, 2), 3, False),
            ("half swap", half_swap, 4, (4, 1), 1, True),
            ("4-view matching", matching, 8, (2, 2), 1, False),
            ("4-view matching", matching, 8, (4, 1), 2, True)):
        rows = _block_route(torch, route, shape, rank, videos)
        B, Bk = rows.shape[0], videos * Fr // shape[1]
        q, k, v = randn(B, N, C), randn(Bk, N, C), randn(Bk, N, C)
        geom, rows = _epi_inputs(torch, g, B, feat, rows)
        label = (f"B{B} Bk{Bk} N{N} C{C} h8 {what}"
                 + (f", rank {rank} of mesh {shape}" if shape != (1, 1) else ", unsharded"))
        cases.append(_case(
            "epi_flash_attention", label,
            lambda q=q, k=k, v=v, geom=geom, rows=rows:
            epi_flash.epi_flash_attention(q, k, v, *geom, heads=8, kv_index=rows),
            lambda q=q, k=k, v=v, geom=geom, rows=rows: epi_flash._plain(q, k, v, geom, rows, 8),
            timed, launch=lambda q=q, k=k, v=v, geom=geom, rows=rows:
            epi_launch(q, k, v, geom, rows),
            library=lambda q=q, k=k, v=v, geom=geom, rows=rows: epi_library(q, k, v, geom, rows),
            library_call="scaled_dot_product_attention, attn_mask = the bias; excludes "
                         "materialising the bias and gathering k/v by kv_index",
            work=(*work.attention_fwd(B, 8, N, N, C // 8, size, True, True), "bfloat16")))
    causal = causal_temporal_mask("causal", Fr).to("cuda")
    for B, F_loc, off, timed in ((4, 16, 0, True), (4, 4, 4, True), (2, 8, 8, True)):
        for masked in (False, True):
            # q a view of the fused projection of the local frames, k / v gathered
            q = randn(B, N, F_loc, 3 * C).split(C, -1)[0]
            k, v = randn(B, N, Fr, C), randn(B, N, Fr, C)
            mask = causal[off:off + F_loc] if masked else None
            case = temporal_case(
                f"B{B} N{N} F{F_loc} G{Fr} C{C} h8 {'causal rows ' if masked else 'no mask'}"
                f"{f'{off}-{off + F_loc}' if masked else ''}"
                + (", frames shard" if F_loc < Fr else ", unsharded"),
                [q, k, v], mask, 8, timed and not masked)
            case["work"] = (*work.temporal_fwd(B, N, F_loc, C, size, masked, G=Fr),
                            "bfloat16" if size == 2 else "float32")
            cases.append(case)
    return cases


def _grads(torch, fn, xs, dout):
    """(dq, dk, dv) of fn through autograd: each is held against its own
    plain version and its own limit (dk and dv sum over every query, so their
    scale would hide a wrong dq)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in xs]
        return torch.autograd.grad(fn(*leaves), leaves, dout)


def _backward_only(torch, fn, xs, dout):
    """-> a function running only the backward of fn's graph, built once."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in xs]
        out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def _random_geometry(torch, g, B, Lq, Lk):
    """Epipolar geometry off any pixel grid: unit-normal lines through a 256 px
    frame [B, Lq, 3], key pixels anywhere in it [2, Lk], band and alpha [B]."""
    ang = torch.rand(B, Lq, generator=g, device="cuda") * (2 * math.pi)
    off = torch.rand(B, Lq, generator=g, device="cuda") * 256
    lines = torch.stack([torch.cos(ang), torch.sin(ang),
                         -off * (torch.cos(ang) + torch.sin(ang))], -1).contiguous()
    return (lines, torch.rand(2, Lk, generator=g, device="cuda") * 256,
            torch.rand(B, generator=g, device="cuda") * 8 + 2,
            torch.rand(B, generator=g, device="cuda") * 0.5 + 0.1)


def _bwd_cases(torch, dtype, g):
    """K6 / K7 at the training shapes (256 px, 16 frames, 1 folded pair = 32
    frame rows, no CFG) and at K6's edges: autograd through the kernels
    (forward kernel + the backward kernel) against autograd of the plain
    version. The timed entries are the backward alone: the K6 / K7 device
    kernels on prepared inputs (and, for K6, buffers), the K6 / K7 wrapper
    from the saved forward, and the plain version's backward from its
    recorded graph; the library
    yardstick is the backward alone of the scaled_dot_product_attention
    graph."""
    import torch.nn.functional as F

    from cvd_tpu_torch.ops import epi_flash, temporal_attn, work

    dev = "cuda"
    size = torch.empty((), dtype=dtype).element_size()
    sdpa = F.scaled_dot_product_attention

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def case(name, label, fwd, plain, xs, dout, timed, kernel_timer, library, library_call, wk,
             wrapper=None, captured=False):
        return _case(name, label, lambda: _grads(torch, fwd, xs, dout),
                     lambda: _grads(torch, plain, xs, dout), timed, launch=kernel_timer,
                     plain_timer=lambda: _backward_only(torch, plain, xs, dout),
                     library=library, library_call=library_call, work=wk, wrapper=wrapper,
                     captured=captured)

    def epi_case(name, label, xs, dout, gm, rt, timed=False):
        def fwd(a, b, c):
            if gm is None:
                return epi_flash.flash_attention(a, b, c, heads=8)
            return epi_flash.epi_flash_attention(a, b, c, *gm, heads=8, kv_index=rt)

        saved = []  # the prepared inputs and the forward's out and lse, made once

        def forward():
            if not saved:
                prep = epi_flash._prepare(*xs, gm, rt, 8)
                saved.extend((prep, *epi_flash._launch(*prep, 8)))
            return saved

        def kernel_timer():
            prep, out, lse = forward()
            bufs = epi_flash._bwd_buffers(prep[0], prep[1], 8)
            return lambda: epi_flash._launch_bwd_kernels(*prep, 8, out, lse, dout, *bufs)

        def wrapper():
            prep, out, lse = forward()
            return getattr(epi_flash, name)(*prep, 8, out, lse, dout)

        def library():
            q, k, v = xs
            hs = [_heads(q, 8)] + [_heads(x if rt is None else x[rt.long()], 8) for x in (k, v)]
            mask = None if gm is None else epi_flash.bias_from_geometry(*gm)[:, None].to(q.dtype)
            return _backward_only(torch, lambda a, b, c: sdpa(a, b, c, attn_mask=mask), hs,
                                  _heads(dout, 8))

        (B, Lq, C), Lk = xs[0].shape, xs[1].shape[1]
        return case(name, label, fwd, lambda a, b, c: epi_flash._plain(a, b, c, gm, rt, 8),
                    xs, dout, timed, kernel_timer, library,
                    "backward of scaled_dot_product_attention" + (
                        "" if gm is None else ", attn_mask = the bias; excludes the bias, the "
                        "k/v gather and the scatter of dk/dv"),
                    (*work.attention_bwd(B, 8, Lq, Lk, C // 8, size, gm is not None,
                                         rt is not None), "bfloat16"), wrapper)

    def temporal_case(label, xs, dout, mask, heads, timed=False):
        def library():
            hs = [_heads(x.reshape(-1, x.shape[2], x.shape[-1]), heads) for x in xs]
            return _backward_only(torch, lambda a, b, c: sdpa(a, b, c, attn_mask=mask), hs,
                                  _heads(dout.reshape(-1, dout.shape[2], dout.shape[-1]), heads))

        def kernel_timer():
            prep = temporal_attn._prepare(*xs, mask, heads)
            return lambda: temporal_attn._launch_bwd(*prep, heads, dout)

        B, N, Fr, C = xs[0].shape
        return case("temporal_flash_attention_bwd", label,
                    lambda a, b, c: temporal_attn.temporal_flash_attention(a, b, c, mask, heads),
                    lambda a, b, c: temporal_attn.temporal_attention_plain(a, b, c, mask, heads),
                    xs, dout, timed, kernel_timer, library,
                    "backward of scaled_dot_product_attention on [B*N, h, F, D]",
                    (*work.temporal_bwd(B, N, Fr, C, size, mask is not None), str(dtype)[6:]),
                    lambda: temporal_attn.temporal_flash_attention_bwd(*xs, mask, heads, dout),
                    captured=True)

    cases = []
    for feat, C in ((32, 320), (16, 640)):
        N, B = feat * feat, 32
        xs, do = (randn(B, N, C), randn(B, N, C), randn(B, N, C)), randn(B, N, C)
        geom, route = _epi_inputs(torch, g, B, feat)
        cases.append(epi_case("epi_flash_attention_bwd", f"B{B} N{N} C{C} h8 routed",
                              xs, do, geom, route, feat == 32))
        cases.append(epi_case("flash_attention_bwd", f"B{B} N{N} C{C} h8",
                              xs, do, None, None, feat == 32))
        causal = _temporal_mask(torch, g, "causal", 16, 16)
        for split in (True, False):  # the main path's layout first: the record's row
            *xt, dot = _temporal_inputs(randn, 2, N, 16, 16, C, split, grad=True)
            cases.append(temporal_case(f"B2 N{N} F16 C{C} h8 {_layout(split)}", xt, dot, None, 8,
                                       feat == 32))
        cases.append(temporal_case(f"B2 N{N} F16 C{C} h8 causal {_layout(False)}", xt, dot,
                                   causal, 8, feat == 32))
    # K6's edges. Res 8 is 64 tokens at head_dim 160 in bf16; the f32 kernels hold a
    # padded head_dim up to 96 in shared memory, so f32 takes 64 tokens at head_dim 80
    C8 = 1280 if dtype == torch.bfloat16 else 640
    shared = (torch.arange(4, device=dev) // 2 * 2).to(torch.int32)  # rows 0, 0, 2, 2
    for label, (B, Lq, Lk, C), bias, rt in (
            (f"B4 N64 C{C8} h8 routed", (4, 64, 64, C8), True, "swap"),
            (f"B4 N64 C{C8} h8", (4, 64, 64, C8), False, None),
            ("B4 Lq200 Lk150 C320 h8 ragged, 2 rows to 1", (4, 200, 150, 320), True, shared),
            ("B4 Lq200 Lk150 C320 h8 ragged", (4, 200, 150, 320), False, None),
            ("B4 N256 C320 h8, 2 rows to 1", (4, 256, 256, 320), True, shared)):
        xs, do = (randn(B, Lq, C), randn(B, Lk, C), randn(B, Lk, C)), randn(B, Lq, C)
        if isinstance(rt, str):
            rt = torch.tensor([2, 3, 0, 1], device=dev, dtype=torch.int32)
        geom = _random_geometry(torch, g, B, Lq, Lk) if bias else None
        cases.append(epi_case("epi_flash_attention_bwd" if bias else "flash_attention_bwd",
                              label, xs, do, geom, rt))
    for B, N, Fr, G, C, h, kind, split in TEMPORAL_EDGES:
        *xs, do = _temporal_inputs(randn, B, N, Fr, G, C, split, grad=True)
        cases.append(temporal_case(
            f"B{B} N{N} F{Fr} G{G} C{C} h{h} {kind or 'no'} mask {_layout(split)}",
            xs, do, _temporal_mask(torch, g, kind, Fr, G), h))
    return cases


def _time_case(torch, case):
    """The timings of one bf16 case, taken in turns inside this one call:
    plain, kernel, kernel, library, then the whole wrapper where the kernel
    was timed alone (``wrapper``, or the public function of a forward case).
    -> the record's entries."""
    from cvd_tpu_torch.ops import work

    launch = case.get("launch")
    k_fn = launch() if launch else case["kernel"]
    p_fn = case["plain_timer"]() if case.get("plain_timer") else case["plain"]
    l_fn = case["library"]()
    with torch.no_grad():
        p_ms = _time_ms(torch, p_fn)
        time_kernel = _time_captured_ms if case.get("captured") else _time_ms
        k_ms = [time_kernel(torch, k_fn), time_kernel(torch, k_fn)]
        l_ms = _time_ms(torch, l_fn)
        # a backward case's ``kernel`` is autograd through forward and backward: its
        # wrapper is timed only where the case names it
        w_fn = case.get("wrapper") or (
            case["kernel"] if launch and not case.get("plain_timer") else None)
        w_ms = _time_ms(torch, w_fn) if w_fn else sum(k_ms) / 2
    flops, moved, arith = case["work"]
    bound, by = work.bound_ms(flops, moved, arith)
    return dict(ms=sum(k_ms) / 2, ms_runs=k_ms, plain_ms=p_ms, library_ms=l_ms,
                library_call=case["library_call"], wrapper_ms=w_ms, bound_ms=bound,
                bound_by=by, timed_shape=case["label"])


def phase_kernels(torch, mesh=False):
    """Every case of ``_cases`` (with ``mesh``: the sharded shapes of phase
    ``mesh``) in f32 with TF32 off and in bf16, against the plain versions;
    the timed bf16 cases in turns. -> {kernel: its record's numbers}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {name: {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "err_over_limit": 0.0,
                     "err_over_limit_f32": 0.0} for name in KERNELS}
    failures = []
    for dtype, tol, key in ((torch.float32, TOL_F32, "_f32"), (torch.bfloat16, TOL_BF16, "")):
        g = torch.Generator(device="cuda").manual_seed(0)
        for case in _cases(torch, dtype, g, mesh):
            name, label = case["name"], case["label"]
            with torch.no_grad():
                got, want = case["kernel"](), case["plain"]()
                torch.cuda.synchronize()
                if not isinstance(got, tuple):  # a backward case gives (dq, dk, dv)
                    got, want = (got,), (want,)
                errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
                limits = [tol * max(1.0, float(b.float().abs().max())) for b in want]
            ok = len(got) == len(want) and all(
                a.shape == b.shape and math.isfinite(e) and e <= lim
                for a, b, e, lim in zip(got, want, errs, limits))
            report[name]["max_abs_err" + key] = max(report[name]["max_abs_err" + key], *errs)
            report[name]["err_over_limit" + key] = max(
                report[name]["err_over_limit" + key], *(e / lim for e, lim in zip(errs, limits)))
            line = (f"[kernel] {name:28s} {str(dtype)[6:]:8s} {label:42s} "
                    f"{'dq/dk/dv ' if len(errs) == 3 else ''}max_abs_err "
                    f"{' '.join(f'{e:.3e}' for e in errs)} "
                    f"(limit {' '.join(f'{lim:.3e}' for lim in limits)})")
            if case["timed"] and dtype == torch.bfloat16:
                t = _time_case(torch, case)
                report[name].setdefault("timings", []).append(t)
                if "ms" not in report[name]:  # the record's row is the first timed shape
                    report[name].update(t)
                line += (f"  kernel {t['ms']:.3f} ms ({t['ms_runs'][0]:.3f}, {t['ms_runs'][1]:.3f})"
                         f"  wrapper {t['wrapper_ms']:.3f} ms  plain {t['plain_ms']:.3f} ms"
                         f"  library {t['library_ms']:.3f} ms [{t['library_call']}]"
                         f"  bound {t['bound_ms']:.3f} ms by {t['bound_by']}")
            log(line + ("" if ok else "  FAILED"))
            if not ok:
                failures.append(f"{name} {label} {dtype}")
            del got, want, case
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return report


def phase_reference(torch):
    """Narrow UNet at 256 px: card (kernels) vs CPU (plain versions)."""
    import numpy as np

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every tensor drawn: the default initialization would leave the epi
    # modules the identity, and K1 out of what is compared
    cpu = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                 generator=torch.Generator().manual_seed(0), random_full=True)
    gpu = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cuda")
    for name in ("unet", "vae", "clip", "pose_encoder"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    rng = np.random.default_rng(0)
    Fr, S = 2, 256
    inputs = dict(
        prompt_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        negative_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        plucker=torch.from_numpy(rng.standard_normal((2, Fr, S, S, 6)).astype(np.float32)),
        F_mats=torch.from_numpy((rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)),
        latents=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4)).astype(np.float32)),
    )
    wrappers = _wrappers()
    before = {n: fn.launches for n, fn in wrappers.items()}
    want = SimplePipeline(cpu, rand_slope_ff=False)(**inputs, num_inference_steps=2,
                                                    decode=False).numpy()
    got = SimplePipeline(gpu, rand_slope_ff=False)(**inputs, num_inference_steps=2,
                                                   decode=False).cpu().numpy()
    used = sorted(n for n, fn in wrappers.items() if fn.launches > before[n])
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    log(f"[reference] narrow UNet 256 px f32: card vs CPU final-latent SNR {snr:.1f} dB "
        f"(kernels used: {', '.join(used)})")
    if not snr >= 60.0:
        raise RuntimeError(f"card vs CPU SNR {snr:.1f} dB < 60 dB")
    _reference_nview(torch, np, cpu, gpu, wrappers)
    _reference_options(torch, np, inputs, wrappers)
    _reference_ckpt(torch, np, cpu, inputs)
    _reference_extras(torch, np, wrappers)


def _snr_db(np, want, got):
    return 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))


def _reference_extras(torch, np, wrappers):
    """The narrow UNet at 256 px (2 videos x 2 frames), card (kernels) vs CPU
    (plain versions), every tensor drawn: a SparseCtrl model of each layout
    (every zero convolution nonzero) feeding its residuals into the UNet, and
    the UNet with ``fuse_first_frame``; outputs at >= 60 dB."""
    import copy
    import dataclasses

    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.models.sparse_controlnet import SparseControlNetModel
    from cvd_tpu_torch.models.unet import UNet3DConditionModel
    from cvd_tpu_torch.pipelines.common import random_init_

    rng = np.random.default_rng(11)
    B, Fr, S = 2, 2, 256
    t = torch.from_numpy
    sample = t(rng.standard_normal((B, Fr, S // 8, S // 8, 4)).astype(np.float32))
    text = t(rng.standard_normal((B, 77, SMOKE_UNET.cross_attention_dim)).astype(np.float32))
    F_mats = t((rng.standard_normal((B * Fr, 3, 3)) * 1e-3).astype(np.float32))
    timesteps = torch.tensor([71, 642])

    def pair(module):
        """(the module on the CPU, a copy on the card)."""
        card = copy.deepcopy(module).cuda().to(memory_format=torch.channels_last)
        return module.eval(), card.eval()

    cases = []
    for simplified in (False, True):
        c, side = (4, S // 8) if simplified else (3, S)
        cond = t(rng.standard_normal((B, Fr, side, side, c)).astype(np.float32))
        mask = t((rng.random((B, Fr, side, side, 1)) > 0.5).astype(np.float32))
        ctrl = SparseControlNetModel(SMOKE_UNET, c, use_simplified_condition_embedding=simplified)
        cases.append((f"SparseCtrl ({'simplified' if simplified else 'pyramid'}) + UNet with "
                      f"its residuals", SMOKE_UNET, (ctrl, cond, mask)))
    cases.append(("UNet with fuse_first_frame",
                  dataclasses.replace(SMOKE_UNET, fuse_first_frame=True), None))
    for what, cfg, sparse in cases:
        unets = pair(random_init_(UNet3DConditionModel(cfg), torch.Generator().manual_seed(13)))
        ctrls = None
        if sparse is not None:
            ctrls = pair(random_init_(sparse[0], torch.Generator().manual_seed(14)))
        outs = []
        before = {n: fn.launches for n, fn in wrappers.items()}
        for i, dev in enumerate(("cpu", "cuda")):
            kw = {}
            with torch.no_grad():
                if ctrls is not None:
                    down, mid = ctrls[i](sample.to(dev), timesteps.to(dev), text.to(dev),
                                         sparse[1].to(dev), sparse[2].to(dev),
                                         conditioning_scale=0.8)
                    kw = dict(down_block_additional_residuals=down,
                              mid_block_additional_residual=mid)
                cond = EpiConditioning(F_mats=F_mats.to(dev), video_length=Fr,
                                       rand_slope_ff=False)
                outs.append(unets[i](sample.to(dev), timesteps.to(dev), text.to(dev), None, cond,
                                     **kw).float().cpu().numpy())
        used = {n: fn.launches - before[n] for n, fn in wrappers.items()
                if fn.launches > before[n]}
        snr = _snr_db(np, *outs)
        log(f"[reference] narrow UNet 256 px f32, {what}: card vs CPU output SNR {snr:.1f} dB "
            f"(launches {used})")
        missing = [n for n in FORWARD if n not in used]
        if not snr >= 60.0 or missing:
            raise RuntimeError(f"{what}: card vs CPU SNR {snr:.1f} dB, kernels not launched "
                               f"{missing}")


def _extended_calls(torch):
    """A context that counts the K2 launches of extended attention (keys of
    twice the queries' length) by wrapping what ``models.layers`` calls."""
    import contextlib

    from cvd_tpu_torch.models import layers

    @contextlib.contextmanager
    def watch():
        kernel, seen = layers.flash_attention, []

        def watched(q, k, v, heads):
            seen.append(k.shape[1] == 2 * q.shape[1])
            return kernel(q, k, v, heads=heads)

        layers.flash_attention = watched
        try:
            yield seen
        finally:
            layers.flash_attention = kernel
    return watch()


def _reference_options(torch, np, inputs, wrappers):
    """The narrow UNet at 256 px with the runtime image LoRA (rank channels //
    2), the sync-LoRA (rank 4) and spatial extended attention, 2 steps; then
    the narrow sampler with PAB reusing every class (4 steps, steps 1 and 3
    reused): card (kernels) vs CPU (plain versions), every tensor drawn (so
    every LoRA ``up`` is nonzero), final latents at >= 60 dB."""
    import dataclasses

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.pab import PABConfig
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    lora = dataclasses.replace(SMOKE_UNET, spatial_lora_rank=-2, sync_lora_rank=4,
                               spatial_extended_attention=True)
    pab = PABConfig(spatial=2, cross=2, temporal=2, epi=2, start_frac=0.0, end_frac=1.0)
    for what, cfg, kw in (("image LoRA + sync-LoRA + extended attention", lora,
                           dict(num_inference_steps=2)),
                          ("PAB reusing every class", SMOKE_UNET,
                           dict(num_inference_steps=4, pab_config=pab))):
        cpu = PipelineModules.create(cfg, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                     generator=torch.Generator().manual_seed(4), random_full=True)
        gpu = PipelineModules.create(cfg, SMOKE_VAE, SMOKE_CLIP, device="cuda")
        for name in ("unet", "vae", "clip", "pose_encoder"):
            getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
        want = SimplePipeline(cpu, rand_slope_ff=False)(**inputs, decode=False, **kw).numpy()
        before = {n: fn.launches for n, fn in wrappers.items()}
        with _extended_calls(torch) as seen:
            got = SimplePipeline(gpu, rand_slope_ff=False)(**inputs, decode=False,
                                                           **kw).cpu().numpy()
        used = {n: fn.launches - before[n] for n, fn in wrappers.items()
                if fn.launches > before[n]}
        snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
        log(f"[reference] narrow UNet 256 px f32, {what}: card vs CPU final-latent SNR "
            f"{snr:.1f} dB (launches {used}; K2 at Lk = 2 Lq {sum(seen)})")
        if not snr >= 60.0 or "epi_flash_attention" not in used or (cfg is lora and not any(seen)):
            raise RuntimeError(f"{what}: card vs CPU SNR {snr:.1f} dB, launches {used}, "
                               f"K2 at Lk = 2 Lq {sum(seen)}")


def _nview_cameras(np, torch, views, frames, size):
    """Plücker maps [V, F, S, S, 6], poses [V*F, 4, 4] and intrinsics [V*F, 3, 3]
    of the ``circle`` pattern, as ``cli.inference_advanced`` makes them."""
    from cvd_tpu_torch.geometry.plucker import ray_condition
    from cvd_tpu_torch.geometry.trajectories import circle_trajectory, default_intrinsics

    c2w = circle_trajectory(views, frames).astype(np.float32)
    K = default_intrinsics(views, frames, size, size).astype(np.float32)
    intr = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], -1)
    plucker = ray_condition(intr[None], c2w[None], size, size)[0]
    return (torch.from_numpy(plucker).reshape(views, frames, size, size, 6),
            torch.from_numpy(c2w), torch.from_numpy(K))


def _reference_nview(torch, np, cpu, gpu, wrappers):
    """The 4-view sampler of the narrow UNet at 256 px, 2 steps, multistep 2,
    accumulate_step 2: on the CPU, and on the card as a loop of UNet calls and
    as batched calls, every draw from a CPU generator of one seed (so the
    pairings and the re-noise agree); final latents at >= 60 dB, the 2-view
    check's limit."""
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    V, Fr, S = 4, 2, 256
    rng = np.random.default_rng(1)
    plucker, c2w, K = _nview_cameras(np, torch, V, Fr, S)
    inputs = dict(
        prompt_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        negative_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        plucker=plucker, c2w=c2w, K_mats=K, num_inference_steps=2, multistep=2,
        accumulate_step=2, decode=False)

    def run(modules, batched):
        # the draws come from a host generator, shared with the CPU run: a
        # captured sampler draws on the card, so the card runs eagerly here
        pipe = AdvancedPipeline(modules, F_mat_size=S, rand_slope_ff=False,
                                accumulate_batched=batched, capture=False)
        return pipe(**inputs, generator=torch.Generator().manual_seed(7)).cpu().numpy()

    want = run(cpu, False)
    for batched in (False, True):
        before = {n: fn.launches for n, fn in wrappers.items()}
        got = run(gpu, batched)
        used = sorted(n for n, fn in wrappers.items() if fn.launches > before[n])
        snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
        log(f"[reference] narrow UNet 256 px f32, 4 views, "
            f"{'batched accumulate' if batched else 'accumulate loop'}: card vs CPU "
            f"final-latent SNR {snr:.1f} dB (kernels used: {', '.join(used)})")
        if not snr >= 60.0 or "epi_flash_attention" not in used:
            raise RuntimeError(f"4-view card vs CPU SNR {snr:.1f} dB (kernels used: {used})")


def _train_batch(torch, np, Fr, S, seed):
    """A pre-encoded training batch: latents, text ids, Plücker maps, F mats."""
    rng = np.random.default_rng(seed)
    return {
        "latents": torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4))
                                    .astype(np.float32)),
        "text_ids": torch.from_numpy(rng.integers(0, 49408, (2, 77))),
        "plucker": torch.from_numpy(rng.standard_normal((2, Fr, S, S, 6)).astype(np.float32)),
        "F_mats": torch.from_numpy((rng.standard_normal((2, Fr, 3, 3)) * 1e-3)
                                   .astype(np.float32)),
    }


def phase_train_reference(torch):
    """One train step of the narrow UNet at 256 px: card (kernels) vs CPU
    (plain versions), same weights, batch, noise, timesteps and slope; then
    the same with the auxiliary q/k head (``additional_channel`` 4) and its
    epipolar loss at weight 1."""
    import dataclasses

    import numpy as np

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Fr, S = 2, 256
    batch = _train_batch(torch, np, Fr, S, seed=1)
    rng = np.random.default_rng(2)
    pinned = dict(noise=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4))
                                         .astype(np.float32)),
                  timesteps=torch.from_numpy(np.array([71, 642])), F_mat_size=S,
                  rand_slope_ff=True, remat=True)
    wrappers = _wrappers()
    for what, unet_cfg, weight in (
            ("", SMOKE_UNET, 0.002),
            (", with the auxiliary head (epi_loss_weight 1)",
             dataclasses.replace(SMOKE_UNET, additional_channel=4), 1.0)):
        cpu = PipelineModules.create(unet_cfg, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                     generator=torch.Generator().manual_seed(1), random_full=True)
        gpu = PipelineModules.create(unet_cfg, SMOKE_VAE, SMOKE_CLIP, device="cuda")
        for name in ("unet", "clip", "pose_encoder"):
            getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
        results = []
        for m in (cpu, gpu):
            before = {n: fn.launches for n, fn in wrappers.items()}
            state = create_train_state(m.unet)
            # a CPU generator on both sides: the same first-frame slope
            loss, epi = loss_and_grads(state, batch, m, torch.Generator().manual_seed(3),
                                         epi_loss_weight=weight, **pinned)
            params = dict(m.unet.named_parameters())
            grads = {n: params[n].grad.detach().cpu().numpy() for n in state.trainable}
            results.append((float(loss), float(epi), grads,
                            sorted(n for n, fn in wrappers.items() if fn.launches > before[n])))
        (want_loss, want_epi, want, _), (got_loss, got_epi, got, used) = results
        cat = np.concatenate
        ref = cat([want[n].ravel() for n in want])
        err = cat([got[n].ravel() for n in want]) - ref
        snr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))
        # a bias on every key shifts each query's logits by one constant, which
        # the softmax ignores: that gradient is 0 up to rounding on both sides
        zero = sorted(n for n, g in got.items() if not np.any(g)
                      and n != "conv_auxiliary_key.bias")
        rel = abs(got_loss - want_loss) / abs(want_loss)
        head = unet_cfg.additional_channel > 0
        rel_epi = abs(got_epi - want_epi) / max(abs(want_epi), 1e-30)
        log(f"[reference] narrow UNet train step 256 px f32, remat on{what}: loss card "
            f"{got_loss:.7f} CPU {want_loss:.7f} (rel {rel:.1e})"
            + (f", epi loss card {got_epi:.7f} CPU {want_epi:.7f} (rel {rel_epi:.1e})"
               if head else "")
            + f"; trainable gradients ({len(want)} tensors) SNR {snr:.1f} dB; zero on the card: "
            f"{len(zero)} (kernels used: {', '.join(used)})")
        if not (rel <= 1e-5 and snr >= 60.0) or zero or (
                head and not (want_epi > 0 and rel_epi <= 1e-5)):
            raise RuntimeError(f"train step{what} card vs CPU: loss rel {rel:.1e}, epi loss "
                               f"{got_epi} vs {want_epi}, SNR {snr:.1f} dB, zero gradients "
                               f"{zero[:5]}")
        missing = [n for n in KERNELS if n not in used]
        if missing:
            raise RuntimeError(f"kernels not launched by the card's train step: {missing}")


_VAE_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _vae_file_key(key):
    """A VAE attention key under the SD-era name the released file has."""
    if ".attentions." in key:
        for new, old in _VAE_LEGACY.items():
            key = key.replace(f".{new}.", f".{old}.")
    return key


def _save_artifacts(torch, root, unet, vae, clip, motion, epi, pose_encoder, processors,
                    lora=None):
    """Write state dicts, keyed as the released files are, as those files:
    the SD folder (``unet/``, ``vae/``, ``text_encoder/`` .bin), the motion
    module, the epi checkpoint nested beside ``epoch`` / ``global_step``, the
    pose adaptor with its two sub-dicts and, with ``lora``, a motion LoRA
    under ``state_dict``. -> the CLI options that name them."""
    for sub in ("unet", "vae", "text_encoder"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    torch.save(unet, os.path.join(root, "unet", "diffusion_pytorch_model.bin"))
    torch.save(vae, os.path.join(root, "vae", "diffusion_pytorch_model.bin"))
    torch.save(clip, os.path.join(root, "text_encoder", "pytorch_model.bin"))
    paths = {"ori_model_path": root, "unet_subfolder": "unet",
             "motion_module_ckpt": os.path.join(root, "v3_sd15_mm.ckpt"),
             "epi_module_ckpt": os.path.join(root, "cvd_epi.ckpt"),
             "pose_adaptor_ckpt": os.path.join(root, "camera_ctrl.ckpt")}
    torch.save(motion, paths["motion_module_ckpt"])
    torch.save({"epoch": 7, "global_step": 50000, "unet_trainable_dict": epi},
               paths["epi_module_ckpt"])
    torch.save({"pose_encoder_state_dict": pose_encoder,
                "attention_processor_state_dict": processors}, paths["pose_adaptor_ckpt"])
    if lora is not None:
        paths["motion_lora_ckpt"] = os.path.join(root, "motion_lora.ckpt")
        torch.save({"state_dict": lora}, paths["motion_lora_ckpt"])
    return paths


def _model_args(inference, paths, *extra, caption_file=None):
    """The 2-view CLI's arguments for the checkpoint files of ``paths``."""
    argv = [f"--{k}={v}" for k, v in paths.items()]
    assets = os.path.join(HERE, "assets")
    return inference.build_parser().parse_args(argv + list(extra) + [
        "--caption_file", caption_file or os.path.join(assets, "example_prompts.json"),
        "--pose_file_0", os.path.join(assets, "pose_files", "example_dolly.txt"),
        "--pose_file_1", os.path.join(assets, "pose_files", "example_arc.txt")])


def _reference_ckpt(torch, np, cpu, inputs):
    """The narrow model of ``cpu`` through checkpoint files: written in the
    released layouts, built by ``build_modules`` on the card and on the CPU."""
    import shutil
    import tempfile

    from cvd_tpu_torch.cli import build, inference
    from cvd_tpu_torch.io.checkpoints import clip_hf_name
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    unet = cpu.unet.state_dict()
    processors = {k: v for k, v in unet.items() if ".processor.qkv_merge." in k}
    motion = {k: v for k, v in unet.items() if "motion_modules" in k and k not in processors}
    epi = {k: v for k, v in unet.items() if "epi_modules" in k}
    base = {k: v for k, v in unet.items()
            if k not in processors and k not in motion and k not in epi}
    root = tempfile.mkdtemp(prefix="chip_smoke_narrow_")
    try:
        paths = _save_artifacts(
            torch, root, base, {_vae_file_key(k): v for k, v in cpu.vae.state_dict().items()},
            {clip_hf_name(k): v for k, v in cpu.clip.state_dict().items()}, motion, epi,
            cpu.pose_encoder.state_dict(), processors)
        args = _model_args(inference, paths)
        built = {dev: build.build_modules(args, torch.device(dev), tokenizer=HashTokenizer(),
                                          widths=build.SMOKE_WIDTHS)[0]
                 for dev in ("cpu", "cuda")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("unet", "vae", "clip", "pose_encoder"):
        want, got = getattr(cpu, name).state_dict(), getattr(built["cpu"], name).state_dict()
        bad = [k for k in want if not torch.equal(want[k], got[k])]
        if bad or set(want) != set(got):
            raise RuntimeError(f"narrow {name} from files differs from what was written: {bad[:5]}")
    kw = dict(num_inference_steps=2, decode=False)
    want = SimplePipeline(built["cpu"], rand_slope_ff=False)(**inputs, **kw).numpy()
    got = SimplePipeline(built["cuda"], rand_slope_ff=False)(**inputs, **kw).cpu().numpy()
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    log(f"[reference] narrow UNet 256 px f32, built from checkpoint files: card vs CPU "
        f"final-latent SNR {snr:.1f} dB")
    if not snr >= 60.0:
        raise RuntimeError(f"from checkpoint files: card vs CPU SNR {snr:.1f} dB < 60 dB")

    # a load into modules that have run: K5's fold cache must not answer with
    # the folds of the weights before
    from cvd_tpu_torch.pipelines.common import PipelineModules

    other = PipelineModules.create(*build.SMOKE_WIDTHS, device="cpu", random_full=True,
                                   generator=torch.Generator().manual_seed(5))
    fresh = PipelineModules.create(*build.SMOKE_WIDTHS, device="cuda")
    for name in ("unet", "vae", "clip", "pose_encoder"):
        state = getattr(other, name).state_dict()
        getattr(built["cuda"], name).load_state_dict(state)
        getattr(fresh, name).load_state_dict(state)
    reloaded = SimplePipeline(built["cuda"], rand_slope_ff=False)(**inputs, **kw)
    anew = SimplePipeline(fresh, rand_slope_ff=False)(**inputs, **kw)
    same = torch.equal(reloaded, anew)
    moved = not np.array_equal(reloaded.cpu().numpy(), got)
    log(f"[reference] other weights loaded into the card's bundle after a run: latents equal "
        f"to a fresh bundle's bit for bit: {same}; differ from the run before: {moved}")
    if not (same and moved):
        raise RuntimeError("a load into used modules gives other latents than a fresh build")


def _resident_gib():
    """(peak, current) resident memory of this process in GiB: ``ru_maxrss``,
    and VmRSS of /proc/self/status (nan where the kernel does not give it)."""
    import resource

    now = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) / 2 ** 20
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, now


LORA_SCALE = 0.5   # --motion_lora_scale of the ckpt phase


def _ckpt_files(torch, root):
    """Draw the released artifacts' tensors (float16, from the manifests) and
    write them under ``root``. -> (the CLI options naming the files, what each
    module's ``state_dict()`` must hold after a load, keyed as the port keys
    them, in the files' dtype)."""
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import SKIP_SUBSTRINGS, clip_rename

    g = torch.Generator(device="cuda").manual_seed(20260)
    f16 = torch.float16
    unet = M.random_state(M.sd15_unet_manifest(), g, f16)
    vae = M.random_state(M.sd15_vae_manifest(), g, f16)
    clip = M.random_state(M.sd15_clip_manifest(), g, f16)
    motion = M.random_state(M.animatediff_v3_mm_manifest(), g, f16)
    epi = M.random_state(M.cvd_epi_ckpt_manifest(), g, f16)
    pose_encoder = M.random_state(M.cameractrl_pose_encoder_manifest(), g, f16)
    processors = M.random_state(M.cameractrl_attention_processor_manifest(), g, f16)
    # a rank-8 motion LoRA over every temporal to_q / to_k / to_v / to_out
    rank, pairs = 8, {}
    for key, w in motion.items():
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            if key.endswith(f".{proj}.weight"):
                stem = f"{key[:-len(f'{proj}.weight')]}processor.{proj.replace('.0', '')}_lora"
                pairs[f"{stem}.down.weight"] = (rank, w.shape[1])
                pairs[f"{stem}.up.weight"] = (w.shape[0], rank)
    lora = M.random_state(pairs, g, f16)
    paths = _save_artifacts(torch, root, unet, {_vae_file_key(k): v for k, v in vae.items()},
                            clip, motion, epi, pose_encoder, processors, lora)

    def params_of(state):
        return {k: v for k, v in state.items() if not any(s in k for s in SKIP_SUBSTRINGS)}

    fused = params_of(motion)
    for key, down in lora.items():
        if ".down." in key:
            target = (key.replace("processor.", "").replace("_lora.down", "")
                      .replace("to_out.", "to_out.0."))
            up = lora[key.replace(".down.", ".up.")]
            # as the loader fuses: products in f32, back in the file's dtype
            fused[target] = (fused[target].float()
                             + LORA_SCALE * (up.float() @ down.float())).to(f16)
    expected = {"unet": {**unet, **fused, **epi, **processors}, "vae": vae,
                "clip": {clip_rename(k): v for k, v in params_of(clip).items()},
                "pose_encoder": params_of(pose_encoder)}
    return paths, expected, epi, len(pairs) // 2


def _held(torch, module, expected, what, skip=()):
    """Every parameter of ``module`` equals ``expected``'s tensor of its name
    cast to the parameter's dtype, bit for bit, and none is missing (so none
    is left at its initial value); 4-D weights on the card are channels_last."""
    params = dict(module.named_parameters())
    names = {k for k in expected if not k.startswith(tuple(skip))} if skip else set(expected)
    if set(params) != names:
        raise RuntimeError(f"{what}: parameters no file covers {sorted(set(params) - names)[:5]}, "
                           f"file keys that name none {sorted(names - set(params))[:5]}")
    bad = [n for n, p in params.items()
           if not torch.equal(p, expected[n].to(p.device).to(p.dtype))]
    strided = [n for n, p in params.items()
               if p.ndim == 4 and p.is_cuda
               and not p.is_contiguous(memory_format=torch.channels_last)]
    if bad or strided:
        raise RuntimeError(f"{what}: parameters that differ from their file's tensor {bad[:5]}; "
                           f"4-D weights not channels_last {strided[:5]}")
    return len(params)


def _ckpt_runs(torch, np, root, sampler, sampler_requests):
    from cvd_tpu_torch.cli import build, inference, train
    from cvd_tpu_torch.io.model_config import load_model_config
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.simple import SimplePipeline
    from cvd_tpu_torch.train.state import create_train_state

    dev, bf16, tok = torch.device("cuda"), torch.bfloat16, HashTokenizer()
    model_config = os.path.join(HERE, "configs", "inference_config.yaml")
    t0 = time.perf_counter()
    paths, expected, epi_file, n_lora = _ckpt_files(torch, root)
    t_write = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    log(f"[ckpt] 6 artifacts + a rank-8 motion LoRA ({n_lora} pairs) written as float16 in "
        f"{t_write:.1f} s, {size / 2**30:.2f} GiB")

    with open(os.path.join(HERE, "assets", "example_prompts.json")) as f:
        prompts = json.load(f)
    one_prompt = os.path.join(root, "prompt.json")
    with open(one_prompt, "w") as f:
        json.dump({"captions": prompts["captions"][:1],
                   "negative_prompts": prompts["negative_prompts"][:1]}, f)
    args = _model_args(
        inference, paths, "--bf16", "--model_config", model_config,
        "--motion_lora_scale", str(LORA_SCALE), "--image_height", "256", "--image_width", "256",
        "--video_length", "16", "--num_inference_steps", "3", "--use_negative_prompt",
        "--out_root", os.path.join(HERE, "build", "chip_smoke_ckpt"), caption_file=one_prompt)
    t0 = time.perf_counter()
    if build.validate_ckpts(args) != 0:
        raise RuntimeError("validate_ckpts refuses the files written from the manifests")
    log(f"[ckpt] validate_ckpts on the files: 0 in {time.perf_counter() - t0:.1f} s")

    # the 2-view sampler from the files
    wrappers = _wrappers()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    (rec,) = inference.main(args, tokenizer=tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    v, ms = rec["videos"], rec["unet_step_ms"]
    run = len(ms) + rec["program"]["warmup_calls"]
    log(f"[ckpt] request from the files: {rec['seconds']:.2f} s end to end ({seconds:.2f} s "
        f"with the module build), UNet steps [{', '.join(f'{x:.1f}' for x in ms)}] ms, peak "
        f"allocated {peak / 2**30:.2f} GiB, video std {float(v.std()):.4f}, launches per UNet "
        f"step run (the warm-up's included) { {n: round(launches[n] / run, 1) for n in FORWARD} }")
    # per request without the warm-ups (phase 5 warmed up once for two requests)
    net = {n: launches[n] - rec["program"]["warmup_launches"][n] for n in FORWARD}
    off = {n: (net[n], sampler[n] / sampler_requests) for n in FORWARD
           if launches[n] == 0 or net[n] * sampler_requests != sampler[n]}
    if v.shape != (2, 16, 256, 256, 3) or not np.isfinite(v).all() or off:
        raise RuntimeError(f"from checkpoint files: videos {v.shape}, finite "
                           f"{np.isfinite(v).all()}, launches (here, a request of phase 5) {off}")

    # a second build: what it takes, and every parameter against its file
    report = {}
    t0 = time.perf_counter()
    modules, _ = build.build_modules(args, dev, tokenizer=tok, report=report)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t_load = sum(r["seconds"] for r in report.values())
    log(f"[ckpt] build from the files: {t_build:.1f} s ({t_build - t_load:.1f} s to create and "
        f"initialize the modules; " + ", ".join(f"{n} {r['keys']} keys {r['seconds']:.2f} s"
                                               for n, r in report.items()) + ")")
    counts = [_held(torch, modules.unet, expected["unet"], "unet"),
              _held(torch, modules.vae, expected["vae"], "vae", skip=("encoder.", "quant_conv.")),
              _held(torch, modules.clip, expected["clip"], "text encoder"),
              _held(torch, modules.pose_encoder, expected["pose_encoder"], "pose encoder")]
    log(f"[ckpt] every parameter equals its file's tensor cast to bf16, bit for bit "
        f"(unet {counts[0]}, vae {counts[1]}, text encoder {counts[2]}, pose encoder {counts[3]}; "
        f"{n_lora} motion-LoRA targets as W + {LORA_SCALE} * up @ down); 4-D weights "
        f"channels_last")

    # the same tensors without files: load_state_dict into an uninitialized bundle
    base, vae_cfg, clip_cfg = build.SD15_WIDTHS
    unet_cfg, pose_kwargs, scheduler, _ = load_model_config(model_config, base=base)
    direct = PipelineModules.create(unet_cfg, vae_cfg, clip_cfg, device=dev, dtype=bf16,
                                    pose_encoder_kwargs=pose_kwargs, scheduler=scheduler)
    direct.unet.load_state_dict(expected["unet"])
    direct.vae.load_state_dict({k: t for k, t in expected["vae"].items()
                                if not k.startswith(("encoder.", "quant_conv."))})
    direct.clip.load_state_dict(expected["clip"])
    direct.pose_encoder.load_state_dict(expected["pose_encoder"])
    rng = np.random.default_rng(0)
    Fr, S = 16, 256
    inputs = dict(
        prompt_ids=torch.from_numpy(tok(prompts["captions"][:1])),
        negative_ids=torch.from_numpy(tok(prompts["negative_prompts"][:1])),
        plucker=torch.from_numpy(rng.standard_normal((2, Fr, S, S, 6)).astype(np.float32)),
        F_mats=torch.from_numpy((rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)),
        latents=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4))
                                 .astype(np.float32)),
        num_inference_steps=2, decode=False)
    lat = [SimplePipeline(m)(**inputs, generator=torch.Generator(device=dev).manual_seed(3))
           for m in (modules, direct)]
    same = torch.equal(lat[0], lat[1])
    log(f"[ckpt] latents of the bundle built from the files and of one filled by "
        f"load_state_dict from the same tensors: equal bit for bit: {same} "
        f"(std {float(lat[0].std()):.4f})")
    if not same or not torch.isfinite(lat[0]).all():
        raise RuntimeError("the bundle built from the files and the one filled directly differ")
    del modules, direct, lat
    torch.cuda.empty_cache()

    # training from the same files
    steps, n_frames, size = 2, 16, 256
    cfg = dict(paths, model_config=model_config, motion_lora_scale=LORA_SCALE, bf16=True,
               sample_size=size, sample_n_frames=n_frames, train_batch_size=1,
               max_train_steps=steps, num_workers=2, remat=True, do_sanity_check=False,
               logger_interval=1, checkpointing_steps=10 ** 9, global_seed=42,
               output_dir=os.path.join(HERE, "build", "chip_smoke_ckpt_train"))
    before, _ = train.build_training_modules(cfg, dev, tok)
    ts = create_train_state(before.unet, frozen_dtype=bf16)
    params = dict(ts.model.named_parameters())
    masters = [k for k, t in epi_file.items()
               if params[k].dtype != torch.float32 or not torch.equal(params[k].cpu(), t.float())]
    if sorted(ts.trainable) != sorted(epi_file) or masters:
        raise RuntimeError(f"f32 masters differ from the epi file before the first step: "
                           f"{masters[:5]}")
    _held(torch, before.vae, expected["vae"], "vae with its encoder")
    del before, ts, params
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = train.run(cfg, sources=[_SeededPairs(steps, n_frames, size)], tokenizer=tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses, secs = out["losses"], out["step_seconds"]
    now = dict(out["state"].model.named_parameters())
    still = [k for k, t in epi_file.items() if torch.equal(now[k].cpu(), t.float())]
    changed = [k for k, t in expected["unet"].items()
               if k not in epi_file and not torch.equal(now[k], t.to(dev).to(bf16))]
    log(f"[ckpt] training from the files: {steps} steps in {seconds:.2f} s (module build "
        f"included), losses [{', '.join(f'{x:.5f}' for x in losses)}], s/step "
        f"[{', '.join(f'{x:.3f}' for x in secs)}], peak allocated {peak / 2**30:.2f} GiB (remat "
        f"on); f32 masters equal to the epi file before the first step ({len(epi_file)} "
        f"tensors), trainable tensors moved {len(epi_file) - len(still)}/{len(epi_file)}, "
        f"frozen tensors off their file's value {len(changed)}/{len(now) - len(epi_file)}, "
        f"captured {out['program']['captured']}, launches {train_launches}")
    missing = [n for n in KERNELS if train_launches[n] == 0]
    if (len(losses) != steps or not all(math.isfinite(x) for x in losses) or still or changed
            or missing):
        raise RuntimeError(f"training from checkpoint files: losses {losses}, trainable tensors "
                           f"not moved {still[:5]}, frozen tensors changed {changed[:5]}, "
                           f"kernels not launched {missing}")
    return ((launches, run), (train_launches, steps)), paths, one_prompt


def phase_ckpt(torch, sampler, sampler_requests, train_seconds=None, unet_ms=None, smi=""):
    """From checkpoint files at SD1.5 width (the module docstring, 8), then
    phases ``options`` (9), ``extras`` (10) and ``civitai`` (12) from the same
    files. ``sampler``: the launch counts of phase 5's ``sampler_requests``
    requests; ``train_seconds``: phase 7's steady step times (None: not run);
    ``unet_ms``: phase 5's median UNet step, ``smi``: the card's name and
    power limit (for phase ``civitai``'s achieved TFLOP/s).
    -> ((sampler launches, UNet steps), (training launches, steps)), and
    phases ``options``', ``extras``' and ``civitai``'s {path: (launches, UNet
    calls or steps)}."""
    import shutil
    import tempfile

    import numpy as np

    free = shutil.disk_usage(tempfile.gettempdir()).free
    # 2.2 G parameters in float16, the options' files and the civitai model and LoRA, and room
    need = 10 * 2 ** 30
    if free < need:
        raise RuntimeError(f"{free / 2**30:.1f} GiB free under {tempfile.gettempdir()}: the "
                           f"checkpoint files need {need / 2**30:.0f} GiB")
    peak_before, before = _resident_gib()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        out, paths, one_prompt = _ckpt_runs(torch, np, root, sampler, sampler_requests)
        t0 = time.perf_counter()
        opts = {f"options_{path}": n
                for path, n in _options_runs(torch, np, root, paths, one_prompt).items()}
        log(f"[time] phase_options: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        opts.update({f"extras_{path}": n for path, n in
                     _extras_runs(torch, np, root, paths, train_seconds).items()})
        log(f"[time] phase_extras: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        opts.update({path: n for path, n in
                     _civitai_runs(torch, np, root, paths, one_prompt, unet_ms, smi).items()})
        log(f"[time] phase_civitai: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(root):
        raise RuntimeError(f"could not remove {root}")
    peak, now = _resident_gib()
    log(f"[ckpt] resident memory of the process: peak {peak:.2f} GiB since the start "
        f"({peak_before:.2f} GiB before the phase), {before:.2f} GiB resident before it, {now:.2f} GiB after; temporary files removed")
    return out, opts


class _PerCall:
    """The launch counts of each UNet call made inside the ``with`` block
    (global module hooks, removed on exit)."""

    def __init__(self, torch, wrappers):
        from cvd_tpu_torch.models.unet import UNet3DConditionModel

        self.torch, self.wrappers, self.calls = torch, wrappers, []
        self.unet = UNet3DConditionModel

    def __enter__(self):
        hooks = self.torch.nn.modules.module

        def pre(mod, args):
            if isinstance(mod, self.unet):
                self.start = {n: fn.launches for n, fn in self.wrappers.items()}

        def post(mod, args, out):
            if isinstance(mod, self.unet):
                self.calls.append({n: fn.launches - self.start[n]
                                   for n, fn in self.wrappers.items()})

        self.handles = [hooks.register_module_forward_pre_hook(pre),
                        hooks.register_module_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def _mean_launches(calls):
    return {n: round(sum(c[n] for c in calls) / len(calls), 1) for n in FORWARD} if calls else {}


def _options_files(torch, root, paths):
    """An image-LoRA file (CameraCtrl's keys, rank channels // 2, under
    ``lora_state_dict``) and an epi checkpoint that carries a sync-LoRA of
    rank 4 (so channels // 2 beside an image LoRA of rank 2), float16 from the
    manifests, every ``up`` nonzero. -> (their paths, the image LoRA's and the
    sync-LoRA's tensors)."""
    from cvd_tpu_torch.io import manifests as M

    g = torch.Generator(device="cuda").manual_seed(20261)
    f16 = torch.float16
    image = M.random_state(M.cameractrl_image_lora_manifest(2), g, f16)
    sync = M.random_state(M.cvd_sync_lora_manifest(4, 2), g, f16)
    epi = M.random_state(M.cvd_epi_ckpt_manifest(), g, f16)
    files = {"image_lora_ckpt": os.path.join(root, "image_lora.ckpt"),
             "epi_module_ckpt": os.path.join(root, "cvd_epi_sync.ckpt")}
    torch.save({"lora_state_dict": image}, files["image_lora_ckpt"])
    torch.save({"epoch": 1, "global_step": 10, "unet_trainable_dict": {**epi, **sync}},
               files["epi_module_ckpt"])
    return files, image, sync


def _options_runs(torch, np, root, paths, one_prompt):
    """Phase ``options`` (the module docstring, 9). -> {path: (launches, UNet
    calls or training steps)}."""
    from cvd_tpu_torch.cli import inference, inference_advanced, train
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.pipelines.pab import PABConfig, reuse_masks

    tok, dev, bf16 = HashTokenizer(), torch.device("cuda"), torch.bfloat16
    model_config = os.path.join(HERE, "configs", "inference_config.yaml")
    t0 = time.perf_counter()
    files, image, sync = _options_files(torch, root, paths)
    log(f"[options] an image LoRA ({len(image)} keys) and an epi checkpoint with a sync-LoRA "
        f"({len(sync)} keys) written as float16 in {time.perf_counter() - t0:.1f} s")
    wrappers = _wrappers()
    common = ("--bf16", "--model_config", model_config, "--image_height", "256",
              "--image_width", "256", "--use_negative_prompt")
    out = {}

    def request(name, module, argv, calls_expected, **kw):
        """One request through ``module.main``: launches counted from 0, per
        UNet call, s/request, ms per call, peak memory."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        with _extended_calls(torch) as seen, _PerCall(torch, wrappers) as per:
            (rec,) = module.main(argv, tokenizer=tok, **kw)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in wrappers.items()}
        v, ms = rec["videos"], rec["unet_step_ms"]
        steady = sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else ms[0]
        log(f"[options] {name}: {rec['seconds']:.2f} s the request, {len(ms)} UNet calls "
            f"[{', '.join(f'{x:.1f}' for x in ms)}] ms (median after the first {steady:.1f}), "
            f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, video "
            f"{tuple(v.shape)} std {float(v.std()):.4f}; launches per UNet call "
            f"{_mean_launches(per.calls)}; K2 at Lk = 2 Lq {sum(seen)} of {len(seen)}")
        missing = [n for n in FORWARD if launches[n] == 0]
        if not np.isfinite(v).all() or len(ms) != calls_expected or missing:
            raise RuntimeError(f"{name}: finite {np.isfinite(v).all()}, {len(ms)} UNet calls "
                               f"(want {calls_expected}), kernels not launched {missing}")
        out[name] = (launches, len(ms) + rec["program"]["warmup_calls"])
        return rec, per.calls, seen

    def args2(*extra, files_=paths):
        return _model_args(inference, files_, *common, *extra, "--out_root",
                           os.path.join(HERE, "build", "chip_smoke_options"),
                           caption_file=one_prompt)

    # (a) the image LoRA, the sync-LoRA and extended attention
    lora_paths = dict(paths, **files)
    _, calls, seen = request("lora", inference, args2(
        "--image_lora_rank", "2", "--sync_lora_rank", "4", "--spatial_extended_attention",
        "--video_length", "16", "--num_inference_steps", "3", files_=lora_paths), 3)
    if not any(seen):
        raise RuntimeError("extended attention launched no K2 at Lk = 2 Lq")
    # (b) multidiff: 2 windows of 12 frames overlapping by 8, 16 frames
    rec, _, _ = request("multidiff", inference, args2(
        "--video_length", "12", "--multidiff_total_steps", "2", "--multidiff_overlaps", "8",
        "--num_inference_steps", "3"), 6)
    if rec["videos"].shape != (2, 16, 256, 256, 3):
        raise RuntimeError(f"multidiff videos {rec['videos'].shape}")
    # (c) PAB (the default ranges) against no PAB, 2 views at 10 steps, then 4 views
    # (5 steps, multistep 2, accumulate 2: 18 UNet calls)
    masks = reuse_masks(10, PABConfig())
    for pab in ((), ("--pab",)):
        name = "pab_2view" if pab else "no_pab_2view"
        _, calls, _ = request(name, inference, args2("--video_length", "16",
                                                     "--num_inference_steps", "10", *pab), 10)
    own = {"spatial": "flash_attention", "temporal": "temporal_flash_attention",
           "epi": "epi_flash_attention"}
    reused = [i for i in range(10) if any(masks[c][i] for c in masks)]
    bad = [(i, c) for i in reused for c, k in own.items() if masks[c][i] and calls[i][k]]
    log(f"[options] PAB 2 views: launches per UNet call on computing steps "
        f"{_mean_launches([calls[i] for i in range(10) if i not in reused])}, on reuse steps "
        f"{_mean_launches([calls[i] for i in reused])} (steps {reused}); a reused class's "
        f"own kernel launched on its reuse steps: {bad or 'never'}")
    if bad:
        raise RuntimeError(f"PAB: reused classes launched their kernels {bad}")
    for pab in ((), ("--pab",)):
        argv = [f"--{k}={v}" for k, v in paths.items()] + list(common) + [
            "--video_length", "16", "--view_num", "4", "--num_inference_steps", "5",
            "--multistep", "2", "--accumulate_step", "2", "--caption_file", one_prompt,
            "--out_root", os.path.join(HERE, "build", "chip_smoke_options_nview"), *pab]
        _, calls, _ = request("pab_4view" if pab else "no_pab_4view", inference_advanced,
                              inference_advanced.build_parser().parse_args(argv), 18)
    masks = reuse_masks(5, PABConfig())
    step_of = [i for i in range(5) for _ in range((2 if i < 4 else 1) * 2)]
    reused = [j for j, i in enumerate(step_of) if any(masks[c][i] for c in masks)]
    bad = [(j, c) for j in reused for c, k in own.items()
           if masks[c][step_of[j]] and calls[j][k]]
    log(f"[options] PAB 4 views: launches per UNet call on computing calls "
        f"{_mean_launches([c for j, c in enumerate(calls) if j not in reused])}, on reuse calls "
        f"{_mean_launches([calls[j] for j in reused])} ({len(reused)} of {len(calls)}); a "
        f"reused class's own kernel launched on its reuse calls: {bad or 'never'}")
    if bad:
        raise RuntimeError(f"PAB 4 views: reused classes launched their kernels {bad}")

    # (d) two training steps with both LoRAs, remat on
    steps, n_frames, size = 2, 16, 256
    cfg = dict(lora_paths, model_config=model_config, lora_rank=2, sync_lora_rank=4, bf16=True,
               sample_size=size, sample_n_frames=n_frames, train_batch_size=1,
               max_train_steps=steps, num_workers=2, remat=True, do_sanity_check=False,
               logger_interval=1, checkpointing_steps=10 ** 9, global_seed=42,
               output_dir=os.path.join(HERE, "build", "chip_smoke_options_train"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = train.run(cfg, sources=[_SeededPairs(steps, n_frames, size)], tokenizer=tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items()}
    now = dict(res["state"].model.named_parameters())
    trainable = set(res["state"].trainable)
    sync_moved = sum(not torch.equal(now[k].cpu(), t.float()) for k, t in sync.items())
    image_same = sum(torch.equal(now[k], t.to(dev).to(bf16)) for k, t in image.items())
    losses = res["losses"]
    log(f"[options] training with both LoRAs: {steps} steps in {seconds:.2f} s (module build "
        f"included), losses [{', '.join(f'{x:.5f}' for x in losses)}], s/step "
        f"[{', '.join(f'{x:.3f}' for x in res['step_seconds'])}], peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (remat on); trainable "
        f"{len(trainable)} tensors, sync-LoRA tensors moved {sync_moved}/{len(sync)}, image "
        f"LoRA tensors equal to their file's {image_same}/{len(image)}, launches {launches}")
    missing = [n for n in KERNELS if launches[n] == 0]
    if (len(losses) != steps or not all(math.isfinite(x) for x in losses)
            or not set(sync) <= trainable or sync_moved != len(sync)
            or image_same != len(image) or missing):
        raise RuntimeError(f"training with both LoRAs: losses {losses}, sync moved {sync_moved}, "
                           f"image LoRA unchanged {image_same}, kernels not launched {missing}")
    out["train_lora"] = (launches, steps)
    return out


def _sparsectrl_files(torch, root):
    """A SparseCtrl file of each layout, float16 from the manifests, every
    tensor drawn (so every zero convolution is nonzero): the pyramid at the
    file's top level, the simplified one under ``state_dict``.
    -> {simplified: (path, state)}."""
    from cvd_tpu_torch.io import manifests as M

    g = torch.Generator(device="cuda").manual_seed(20262)
    files = {}
    for simplified in (False, True):
        state = M.random_state(M.animatediff_sparsectrl_manifest(simplified), g, torch.float16)
        path = os.path.join(root, f"sparsectrl_{'rgb' if simplified else 'scribble'}.ckpt")
        torch.save({"state_dict": state} if simplified else state, path)
        files[simplified] = (path, state)
    return files


def _watch_group_norm(torch):
    """A context that records the (rows, pixels, channels) of every GroupNorm
    the models run, by wrapping what ``models.layers`` calls."""
    import contextlib

    from cvd_tpu_torch.models import layers

    @contextlib.contextmanager
    def watch():
        kernel, seen = layers.group_norm, []

        def watched(x, *args, **kw):
            seen.append((x.shape[0], x[0, ..., 0].numel(), x.shape[-1]))
            return kernel(x, *args, **kw)

        layers.group_norm = watched
        try:
            yield seen
        finally:
            layers.group_norm = kernel
    return watch()


def _extras_runs(torch, np, root, paths, train_seconds):
    """Phase ``extras`` (the module docstring, 10). -> {path: (launches, calls
    or steps)}."""
    import dataclasses
    import logging

    import yaml

    from cvd_tpu_torch.cli import build, inference, train
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.models.unet import UNet3DConditionModel
    from cvd_tpu_torch.pipelines.common import random_init_

    tok, dev, bf16 = HashTokenizer(), torch.device("cuda"), torch.bfloat16
    model_config = os.path.join(HERE, "configs", "inference_config.yaml")
    wrappers = _wrappers()
    out = {}
    t0 = time.perf_counter()
    files = _sparsectrl_files(torch, root)
    log(f"[extras] SparseCtrl files (pyramid {len(files[False][1])} keys, simplified "
        f"{len(files[True][1])} keys) written as float16 in {time.perf_counter() - t0:.1f} s")

    def counted(fn, repeats=1):
        """fn() once with the counts from 0, then ``repeats`` timed calls:
        -> (its result, launches, ms per call)."""
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        result = fn()
        launches = {n: w.launches for n, w in wrappers.items()}
        return result, launches, _time_ms(torch, fn, iters=repeats)

    # (a) SparseCtrl through build_modules, then the UNet with its residuals
    rng = np.random.default_rng(21)
    R, Fr, S = 4, 16, 256
    sample = torch.from_numpy(rng.standard_normal((R, Fr, S // 8, S // 8, 4))
                              .astype(np.float32)).to(dev)
    plucker = torch.from_numpy(rng.standard_normal((R, Fr, S, S, 6)).astype(np.float32))
    F_mats = torch.from_numpy((rng.standard_normal((R * Fr, 3, 3)) * 1e-3)
                              .astype(np.float32)).to(dev)
    timesteps = torch.tensor([701] * R, device=dev)
    for simplified, (path, state) in files.items():
        layout = "simplified" if simplified else "pyramid"
        extra = ("--controlnet_ckpt", path) + (("--controlnet_simplified_embedding",)
                                               if simplified else ())
        args = _model_args(inference, paths, "--bf16", "--model_config", model_config, *extra)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        modules, _ = build.build_modules(args, dev, tokenizer=tok)
        t_build = time.perf_counter() - t0
        n = _held(torch, modules.controlnet, state, f"SparseCtrl {layout}",
                  skip=[k for k in state if "pos_encoder" in k])
        ctrl, unet = modules.controlnet, modules.unet
        c, side = (4, S // 8) if simplified else (3, S)
        cond = torch.from_numpy(rng.uniform(-1, 1, (R, Fr, side, side, c)).astype(np.float32))
        mask = torch.zeros(R, Fr, side, side, 1)
        mask[:, ::5] = 1.0   # sparse: every fifth frame carries its condition
        with torch.no_grad():
            text = modules.clip(torch.from_numpy(tok(["a scenic video"] * R)).to(dev))
            pose = modules.pose_encoder(plucker.to(dev, bf16))
            cond, mask = cond.to(dev), mask.to(dev)
            (down, mid), ctrl_launches, ctrl_ms = counted(
                lambda: ctrl(sample, timesteps, text, cond, mask, conditioning_scale=1.0),
                repeats=3)
            epi = EpiConditioning(F_mats=F_mats, video_length=Fr, rand_slope_ff=False)
            with_res, unet_launches, unet_ms = counted(lambda: unet(
                sample, timesteps, text, pose, epi, down_block_additional_residuals=down,
                mid_block_additional_residual=mid))
            without = unet(sample, timesteps, text, pose, epi)
        diff = float((with_res.float() - without.float()).abs().max())
        finite = bool(torch.isfinite(with_res).all() and all(torch.isfinite(r).all()
                                                             for r in down))
        log(f"[extras] SparseCtrl {layout}: build_modules {t_build:.1f} s, {n} parameters equal "
            f"to the file's tensors cast to bf16; one call at {R} CFG rows x {Fr} frames "
            f"{ctrl_ms:.1f} ms, launches per call "
            f"{ {k: ctrl_launches[k] for k in FORWARD} }, {len(down)} residuals + mid; the UNet "
            f"with them {unet_ms:.1f} ms, launches {  {k: unet_launches[k] for k in FORWARD} }, "
            f"finite {finite}, max |with - without| {diff:.4f}")
        missing = [k for k in ("flash_attention", "temporal_flash_attention", "group_norm",
                               "layer_norm_matmul") if ctrl_launches[k] == 0]
        if not finite or not diff > 0 or missing or len(down) != 12:
            raise RuntimeError(f"SparseCtrl {layout}: finite {finite}, difference {diff}, "
                               f"kernels not launched {missing}")
        out[f"sparsectrl_{layout}"] = (ctrl_launches, 1)
        del modules, ctrl, unet, down, mid, with_res, without
    torch.cuda.empty_cache()

    # (b) one UNet call with fuse_first_frame at SD1.5 width
    cfg = dataclasses.replace(build.SD15_WIDTHS[0], fuse_first_frame=True)
    with torch.device("meta"):
        unet = UNet3DConditionModel(cfg)
    unet = random_init_(unet.to_empty(device=dev), torch.Generator(device=dev).manual_seed(3))
    unet = unet.to(bf16).eval().requires_grad_(False).to(memory_format=torch.channels_last)
    text = torch.randn(R, 77, cfg.cross_attention_dim, device=dev, dtype=bf16)
    epi = EpiConditioning(F_mats=F_mats, video_length=Fr, rand_slope_ff=False)
    with torch.no_grad(), _watch_group_norm(torch) as seen:
        fused, launches, ms = counted(lambda: unet(sample, timesteps, text, None, epi))
    fusion = sorted({(r, p, c) for r, p, c in seen if r == R * (Fr - 1)})
    want = [(R * (Fr - 1), 16, 2560), (R * (Fr - 1), 16, 3840), (R * (Fr - 1), 1024, 640),
            (R * (Fr - 1), 1024, 960)]
    log(f"[extras] UNet with fuse_first_frame, {R} CFG rows x {Fr} frames: {ms:.1f} ms, finite "
        f"{bool(torch.isfinite(fused).all())}, launches {  {k: launches[k] for k in FORWARD} }; "
        f"K4 at the fusion blocks' (rows, pixels, channels) {fusion}")
    if not torch.isfinite(fused).all() or fusion != want:
        raise RuntimeError(f"fuse_first_frame: finite {bool(torch.isfinite(fused).all())}, "
                           f"GroupNorm shapes of the fusion blocks {fusion}")
    out["fuse_first_frame"] = (launches, 1)
    del unet, fused
    torch.cuda.empty_cache()

    # (c) training from the files with the latents cache, the head and validation
    with open(model_config) as f:
        raw = yaml.safe_load(f)
    raw["unet_additional_kwargs"]["additional_channel"] = 64
    head_config = os.path.join(root, "inference_config_aux.yaml")
    with open(head_config, "w") as f:
        yaml.safe_dump(raw, f)
    steps, items = 4, 2
    pose_files = {k: os.path.join(HERE, "assets", "pose_files", f"example_{n}.txt")
                  for k, n in (("pose_file_0", "dolly"), ("pose_file_1", "arc"))}
    out_dir = os.path.join(HERE, "build", "chip_smoke_extras_train")
    cfg = dict(paths, model_config=head_config, bf16=True, sample_size=S, sample_n_frames=Fr,
               train_batch_size=1, max_train_steps=steps, num_workers=2, remat=True,
               do_sanity_check=False, logger_interval=1, checkpointing_steps=10 ** 9,
               global_seed=42, output_dir=out_dir, cache_latents=True,
               latents_cache_dir=os.path.join(root, "latents_cache"), latents_cache_items=items,
               epi_loss_weight=0.002, validation_steps=2, validation_steps_num=3,
               validation_data=dict(pose_files, prompts=["a scenic video"]))
    init, _ = train.build_training_modules(cfg, dev, tok)
    head = {k: p.detach().float().cpu() for k, p in init.unet.named_parameters()
            if "auxiliary" in k}
    del init
    # the same training without the cache (and without validation): its s/step
    for w in wrappers.values():
        w.launches = 0
    plain = train.run(dict(cfg, cache_latents=False, validation_steps=0,
                           output_dir=out_dir + "_no_cache"),
                      sources=[_SeededPairs(items, Fr, S)], tokenizer=tok)
    out["train_no_cache"] = ({n: w.launches for n, w in wrappers.items()}, steps)
    no_cache = sorted(plain["step_seconds"][1:])[(steps - 1) // 2]
    del plain
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = train.run(cfg, sources=[_SeededPairs(items, Fr, S)], tokenizer=tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    cache, losses, epis, secs = (res["latents_cache"], res["losses"], res["epi_losses"],
                                 res["step_seconds"])
    now = dict(res["state"].model.named_parameters())
    moved = sum(not torch.equal(now[k].detach().float().cpu(), v) for k, v in head.items())
    vdir = os.path.join(out_dir, "validation")
    written = sorted(os.listdir(vdir)) if os.path.isdir(vdir) else []
    again = train._latents_cache(cfg, None, None, out_dir, logging.getLogger("chip_smoke"))[1]
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    phase7 = (f"{sorted(train_seconds)[len(train_seconds) // 2]:.3f} s" if train_seconds
              else "not run (--ckpt)")
    per_item = cache["item_seconds"]
    log(f"[extras] training from the files with the latents cache, the auxiliary head "
        f"(additional_channel 64, epi_loss_weight 0.002) and validation every 2 steps: {steps} "
        f"steps in {seconds:.2f} s (module build, cache and validation included); losses "
        f"[{', '.join(f'{x:.5f}' for x in losses)}], epi losses "
        f"[{', '.join(f'{x:.5f}' for x in epis)}], s/step [{', '.join(f'{x:.3f}' for x in secs)}]"
        f", steady (median after the first) {steady:.3f} s with the cache against "
        f"{no_cache:.3f} s without it (the same run otherwise, just before) and phase 7's "
        f"{phase7} (no cache, no head, random weights); cache: {cache['items']} items built in "
        f"{cache['seconds']:.2f} s (per item [{', '.join(f'{x:.2f}' for x in per_item)}] s, "
        f"the first with the encoder's first launches), built again on a second look: "
        f"{again['built']}; peak allocated {peak / 2**30:.2f} GiB (remat on); head "
        f"tensors moved {moved}/{len(head)}; validation files {written}; launches {launches}")
    missing = [n for n in KERNELS if launches[n] == 0]
    if (len(losses) != steps or not all(math.isfinite(x) for x in losses + epis)
            or not all(x > 0 for x in epis) or moved != len(head) or len(head) != 4
            or not cache["built"] or cache["items"] != items or again["built"]
            or not {"step-2.npy", "step-4.npy"} <= set(written) or missing):
        raise RuntimeError(f"training with the extras: losses {losses}, epi {epis}, head moved "
                           f"{moved}/{len(head)}, cache {cache} (again {again}), validation "
                           f"{written}, kernels not launched {missing}")
    out["train_extras"] = (launches, steps)
    return out


CIVITAI_ALPHA = 0.6   # apply_civitai_lora's default, as the entry points fuse
KOHYA_RANK = 8
# the layers a kohya SD1.5 LoRA trains: the spatial attentions' projections,
# the transformers' 1x1-conv proj_in / proj_out and ff; the text encoder's
# attention projections
KOHYA_UNET = (".to_q.weight", ".to_k.weight", ".to_v.weight", ".to_out.0.weight",
              ".proj_in.weight", ".proj_out.weight", ".ff.net.0.proj.weight",
              ".ff.net.2.weight")
KOHYA_TE = (".q_proj.weight", ".k_proj.weight", ".v_proj.weight", ".out_proj.weight")


def _civitai_files(torch, root):
    """(a) A civitai single-file model (the LDM manifests, float16, a seed of
    its own, ``torch.save``d under ``state_dict``) and a kohya LoRA over it
    (rank 8, ``.alpha`` entries) under ``root``. -> (model path, LoRA path,
    the model's state, the LoRA's state, the UNet's LoRA targets)."""
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.ldm_convert import convert_ldm_clip_state, convert_ldm_unet_state

    g = torch.Generator(device="cuda").manual_seed(20262)
    f16 = torch.float16
    ldm = {}
    for manifest in (M.ldm_sd15_unet_manifest(), M.ldm_sd15_vae_manifest(),
                     M.ldm_sd15_clip_manifest()):
        ldm.update(M.random_state(manifest, g, f16))
    pairs, targets = {}, []
    for prefix, state, ends in (("lora_unet_", convert_ldm_unet_state(ldm), KOHYA_UNET),
                                ("lora_te_", convert_ldm_clip_state(ldm), KOHYA_TE)):
        for key, w in state.items():
            if not key.endswith(ends):
                continue
            stem = prefix + key[: -len(".weight")].replace(".", "_")
            tail = tuple(w.shape[2:])   # a 1x1 conv's LoRA is a 1x1 conv too
            pairs[f"{stem}.lora_down.weight"] = (KOHYA_RANK, w.shape[1]) + tail
            pairs[f"{stem}.lora_up.weight"] = (w.shape[0], KOHYA_RANK) + tail
            if prefix == "lora_unet_":
                targets.append(key)
    lora = M.random_state(pairs, g, f16)
    for i, stem in enumerate(sorted({k.split(".")[0] for k in pairs})):
        lora[f"{stem}.alpha"] = torch.tensor(float(1 + i % 8), dtype=f16)
    model, lora_path = os.path.join(root, "civitai_model.ckpt"), os.path.join(root, "kohya.ckpt")
    torch.save({"state_dict": ldm, "global_step": 123}, model)
    torch.save(lora, lora_path)
    return model, lora_path, ldm, lora, targets


def _civitai_expected(torch, ldm, lora, targets, dev):
    """What the sampler's bundle must hold after the civitai build: {module:
    {key: tensor on the card in bf16}}: the file's tensors cast, the LoRA's
    targets as W + 0.6 * (alpha / r) * up @ down computed as the fusion does
    (products in f32 on the card, the bf16 weight as W)."""
    from cvd_tpu_torch.io.checkpoints import SKIP_SUBSTRINGS, clip_rename, vae_legacy_rename
    from cvd_tpu_torch.io.ldm_convert import (
        convert_ldm_clip_state, convert_ldm_unet_state, convert_ldm_vae_state,
    )

    bf16 = torch.bfloat16
    unet = {k: v.to(dev).to(bf16) for k, v in convert_ldm_unet_state(ldm).items()}
    for key in targets:
        stem = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
        up, down = lora[f"{stem}.lora_up.weight"], lora[f"{stem}.lora_down.weight"]
        w = unet[key]
        scale = CIVITAI_ALPHA * float(lora[f"{stem}.alpha"]) / KOHYA_RANK
        unet[key] = (w.reshape(w.shape[0], -1).float() + scale * (
            up.reshape(up.shape[0], -1).to(dev).float()
            @ down.reshape(KOHYA_RANK, -1).to(dev).float())).to(bf16).reshape(w.shape)
    vae = {}
    for k, v in convert_ldm_vae_state(ldm).items():
        k = vae_legacy_rename(k)
        if k.startswith(("decoder.", "post_quant_conv.")):   # the sampler's VAE decodes only
            vae[k] = v.reshape(v.shape[:2]) if ".attentions." in k and v.ndim == 4 else v
    clip = {clip_rename(k): v for k, v in convert_ldm_clip_state(ldm).items()
            if not any(s in k for s in SKIP_SUBSTRINGS)}
    return {"unet": unet, "vae": {k: v.to(dev).to(bf16) for k, v in vae.items()},
            "clip": {k: v.to(dev).to(bf16) for k, v in clip.items()}}


def _civitai_runs(torch, np, root, paths, one_prompt, unet_ms, smi):
    """Phase ``civitai`` (the module docstring, 12). -> {path: (launches,
    UNet calls or training steps)}."""
    import contextlib
    import io

    from cvd_tpu_torch.cli import build, eval_parity, inference, train
    from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.io.torch_io import load_torch_state
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.models.pose_adaptor import PoseAdaptor
    from cvd_tpu_torch.pipelines.simple import SimplePipeline
    from cvd_tpu_torch.schedulers.inversion import ddim_invert
    from cvd_tpu_torch.utils.flops import unet_apply_flops
    from cvd_tpu_torch.utils.profiling import kernel_summary, trace

    tok, dev, bf16 = HashTokenizer(), torch.device("cuda"), torch.bfloat16
    model_config = os.path.join(HERE, "configs", "inference_config.yaml")
    wrappers = _wrappers()
    out = {}

    def counted(path, fn, calls=None):
        """Run ``fn`` with every count set to 0 just before and read just
        after; -> fn's result. ``calls``: fn's result -> its UNet calls."""
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        res = fn()
        torch.cuda.synchronize()
        out[path] = ({n: w.launches for n, w in wrappers.items()}, calls(res) if calls else 1)
        return res

    # (a) the two files
    t0 = time.perf_counter()
    model, lora_path, ldm, lora, targets = _civitai_files(torch, root)
    log(f"[civitai] (a) a civitai model ({len(ldm)} keys, {os.path.getsize(model) / 2**30:.2f} "
        f"GiB float16) and a rank-{KOHYA_RANK} kohya LoRA ({len(lora)} keys: "
        f"{len(targets)} UNet layers, {sum(k.startswith('lora_te_') for k in lora) // 3} text "
        f"encoder layers) written in {time.perf_counter() - t0:.1f} s")
    files = dict(paths, civitai_base_model=model, civitai_lora_ckpt=lora_path)
    common = ("--bf16", "--model_config", model_config, "--motion_lora_scale", str(LORA_SCALE),
              "--image_height", "256", "--image_width", "256", "--video_length", "16",
              "--use_negative_prompt")

    # (b) the build, and every weight against the files
    args = _model_args(inference, files, *common, "--num_inference_steps", "10",
                       "--out_root", os.path.join(HERE, "build", "chip_smoke_civitai"),
                       caption_file=one_prompt)
    report = {}
    t0 = time.perf_counter()
    modules, _ = build.build_modules(args, dev, tokenizer=tok, report=report)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    plain, _ = build.build_modules(_model_args(inference, paths, *common, caption_file=one_prompt),
                                   dev, tokenizer=tok)
    expected = _civitai_expected(torch, ldm, lora, targets, dev)
    bad = {}
    for name, want in expected.items():
        params = dict(getattr(modules, name).named_parameters())
        if name != "unet" and set(params) != set(want):
            raise RuntimeError(f"civitai {name}: parameters {sorted(set(params) ^ set(want))[:5]}")
        bad[name] = [k for k, t in want.items() if not torch.equal(params[k], t)]
    ours = dict(modules.unet.named_parameters())
    theirs = dict(plain.unet.named_parameters())
    others = [k for k in ours if k not in expected["unet"]]
    moved = [k for k in others if not torch.equal(ours[k], theirs[k])]
    pose = [k for k, p in modules.pose_encoder.named_parameters()
            if not torch.equal(p, dict(plain.pose_encoder.named_parameters())[k])]
    log(f"[civitai] (b) build with --civitai_base_model and --civitai_lora_ckpt: {t_build:.1f} s ("
        + ", ".join(f"{n} {r['keys']} keys {r['seconds']:.2f} s" for n, r in report.items())
        + f"); every spatial UNet ({len(expected['unet'])}), VAE ({len(expected['vae'])}) and "
        f"text-encoder ({len(expected['clip'])}) tensor equal to the file's cast to bf16, the "
        f"{len(targets)} LoRA targets to W + {CIVITAI_ALPHA} * (alpha / {KOHYA_RANK}) * up @ "
        f"down, bit for bit: differing {({n: len(b) for n, b in bad.items()})}; the text "
        f"encoder not fused (its tensors the file's); motion / epi / pose tensors "
        f"({len(others)} UNet, {len(dict(modules.pose_encoder.named_parameters()))} pose "
        f"encoder) off phase ckpt's build: {len(moved) + len(pose)}")
    if any(bad.values()) or moved or pose or report["civitai_lora"]["keys"] != len(targets):
        raise RuntimeError(f"civitai build: differing {({n: b[:3] for n, b in bad.items()})}, "
                           f"motion / epi / pose moved {(moved + pose)[:5]}")
    del plain, expected, ours, theirs
    torch.cuda.empty_cache()

    # (c) one 2-view request of 10 steps, and with --pab; eval_parity on the two
    videos = {}
    for path, extra in (("sampler", ()), ("pab", ("--pab",))):
        a = _model_args(inference, files, *common, *extra, "--num_inference_steps", "10",
                        "--out_root", os.path.join(HERE, "build", f"chip_smoke_civitai_{path}"),
                        caption_file=one_prompt)
        t0 = time.perf_counter()
        (rec,) = counted(f"civitai_{path}", lambda: inference.main(a, tokenizer=tok),
                         lambda recs: len(recs[0]["unet_step_ms"])
                         + recs[0]["program"]["warmup_calls"])
        v = rec["videos"]
        launches = out[f"civitai_{path}"][0]
        log(f"[civitai] (c) request{' with --pab' if extra else ''}: {rec['seconds']:.2f} s "
            f"({time.perf_counter() - t0:.2f} s with the civitai build), UNet steps median "
            f"{float(np.median(rec['unet_step_ms'][1:])):.1f} ms, launches per UNet call "
            f"{ {n: round(launches[n] / out[f'civitai_{path}'][1], 1) for n in FORWARD} } "
            f"(UNet calls run, the warm-up's included)")
        missing = [n for n in FORWARD if launches[n] == 0]
        if v.shape != (2, 16, 256, 256, 3) or not np.isfinite(v).all() or missing:
            raise RuntimeError(f"civitai request {path}: {v.shape}, finite "
                               f"{np.isfinite(v).all()}, kernels not launched {missing}")
        videos[path] = os.path.join(root, f"civitai_{path}.npy")
        np.save(videos[path], v.reshape(-1, *v.shape[2:]))
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        code = eval_parity.main(["--ref", videos["sampler"], "--test", videos["pab"], "--json"])
    parity = json.loads(stdout.getvalue().strip().splitlines()[-1])
    log(f"[civitai] (c) eval_parity --json, PAB against no PAB over 32 frames: PSNR mean "
        f"{parity['psnr_mean_db']} dB, min {parity['psnr_min_db']} dB, SSIM mean "
        f"{parity['ssim_mean']}, exit {code} at 35 dB (random weights: this measures PAB's "
        f"drift from the request without it, not quality)")

    # (d) invert (c)'s final latents through the UNet, then sample again from the noise
    sample = ValRealEstate10KPoseFolded(
        validation_prompts=json.load(open(one_prompt))["captions"][:1],
        pose_file_0=args.pose_file_0, pose_file_1=args.pose_file_1, sample_n_frames=16,
        sample_size=256)[0]
    prompt = torch.from_numpy(tok([sample["validation_prompt"]]))
    negative = torch.from_numpy(tok(json.load(open(one_prompt))["negative_prompts"][:1]))
    plucker = torch.from_numpy(sample["plucker_embedding"]).float().reshape(2, 16, 256, 256, 6)
    F_mats = torch.from_numpy(sample["F_mats"]).float().reshape(2, 16, 3, 3)
    pipe = SimplePipeline(modules, F_mat_size=256, rand_slope_ff=True)

    def sampled(latents=None):
        return pipe(prompt, negative, plucker, F_mats, num_inference_steps=10,
                    generator=torch.Generator(device=dev).manual_seed(args.global_seed),
                    latents=latents, decode=False)

    adaptor = PoseAdaptor(modules, F_mat_size=256, rand_slope_ff=False)
    with torch.no_grad():
        text = modules.clip(prompt.to(dev)).repeat(2, 1, 1)   # the conditional rows only
        pl, fm = plucker.to(dev, bf16), F_mats.to(dev)

    def eps_fn(lat, t):
        with torch.no_grad():
            return adaptor(lat, torch.full((2,), t, device=dev), text, pl, fm).float()

    state = modules.scheduler.set_timesteps(10)

    def invert_and_resample():
        final = sampled()
        noise, trajectory = ddim_invert(eps_fn, modules.scheduler, state, final)
        return final, noise, trajectory, sampled(noise)

    t0 = time.perf_counter()
    final, noise, trajectory, again = counted(
        "civitai_inversion", invert_and_resample, lambda r: 3 * 10)
    seconds = time.perf_counter() - t0
    launches = out["civitai_inversion"][0]
    err = float((again - final).abs().max()) / float(final.abs().max())
    finite = all(bool(torch.isfinite(x).all()) for x in (final, noise, trajectory, again))
    log(f"[civitai] (d) ddim_invert of the request's final latents ({tuple(final.shape)}) through "
        f"the UNet (conditional rows, 10 steps), then sampling from the inverted noise: "
        f"{seconds:.2f} s for the 30 UNet calls; round trip max |again - final| / max |final| "
        f"{err:.4f}, inverted noise std {float(noise.std()):.4f}, trajectory "
        f"{tuple(trajectory.shape)}; finite {finite}; launches {launches}")
    missing = [n for n in FORWARD if launches[n] == 0]
    if not finite or trajectory.shape[0] != 10 or missing:
        raise RuntimeError(f"civitai inversion: finite {finite}, kernels not launched {missing}")
    # (g) utils.profiling.trace over one UNet call
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.standard_normal((4, 16, 32, 32, 4)).astype(np.float32)).to(dev)
    ctx = torch.from_numpy(rng.standard_normal((4, 77, 768)).astype(np.float32)).to(dev)
    feats = [torch.from_numpy(rng.standard_normal((4, 16, 32 >> i, 32 >> i, c))
                              .astype(np.float32)).to(dev, bf16)
             for i, c in enumerate((320, 640, 1280, 1280))]
    def unet_call():
        cond = EpiConditioning(F_mats=fm.reshape(32, 3, 3).repeat(2, 1, 1), video_length=16,
                               rand_slope_ff=False)
        with torch.no_grad():
            return modules.unet(lat, 500, ctx, feats, cond)

    unet_call()
    torch.cuda.synchronize()
    trace_dir = _profile_dir("civitai_unet_call")
    with trace(trace_dir) as prof:
        t0 = time.perf_counter()
        unet_call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    sums = {fam: sum(e["dur"] for e in events if fam in e["name"]) / 1e3 for fam in PORT_KERNELS}
    summary = kernel_summary(prof, wall, 1, "one UNet call (4 CFG rows x 16 frames)",
                             PORT_KERNELS)
    log(f"[civitai] (g) utils.profiling.trace over one UNet call: {path} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} kernel events, "
        f"{sum(e['dur'] for e in events) / 1e3:.1f} ms of kernels in {wall * 1e3:.1f} ms wall); "
        f"port kernels summed from the file (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in sums.items() if v))
    for line in summary["lines"][:1] + summary["lines"][-len(PORT_KERNELS):]:
        log(f"[civitai] (g) {line}")
    if not events or not any(sums.values()):
        raise RuntimeError("the trace holds no kernel of the port")
    del modules, pipe, adaptor, final, noise, trajectory, again, feats, lat, ctx
    torch.cuda.empty_cache()

    # (e) two training steps with the civitai_* config keys
    steps = 2
    cfg = dict(files, model_config=model_config, motion_lora_scale=LORA_SCALE, bf16=True,
               sample_size=256, sample_n_frames=16, train_batch_size=1, max_train_steps=steps,
               num_workers=2, remat=True, do_sanity_check=False, logger_interval=1,
               checkpointing_steps=10 ** 9, global_seed=42,
               output_dir=os.path.join(HERE, "build", "chip_smoke_civitai_train"))
    torch.cuda.reset_peak_memory_stats()
    run = counted("civitai_train", lambda: train.run(
        cfg, sources=[_SeededPairs(steps, 16, 256)], tokenizer=tok), lambda r: steps)
    out["civitai_train"] = (out["civitai_train"][0], steps)
    epi = load_torch_state(paths["epi_module_ckpt"], "unet_trainable_dict")
    now = dict(run["state"].model.named_parameters())
    still = [k for k, t in epi.items() if torch.equal(now[k].cpu(), t.float())]
    civitai_kept = [k for k in ("conv_in.weight", "mid_block.resnets.0.conv1.weight")
                    if torch.equal(now[k], ldm["model.diffusion_model." + {
                        "conv_in.weight": "input_blocks.0.0.weight",
                        "mid_block.resnets.0.conv1.weight": "middle_block.0.in_layers.2.weight",
                    }[k]].to(dev).to(now[k].dtype))]
    launches = out["civitai_train"][0]
    log(f"[civitai] (e) cli.train.run with civitai_base_model and civitai_lora_ckpt: losses "
        f"[{', '.join(f'{x:.5f}' for x in run['losses'])}], s/step "
        f"[{', '.join(f'{x:.3f}' for x in run['step_seconds'])}], peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; trainable tensors moved "
        f"{len(epi) - len(still)}/{len(epi)}; frozen spatial weights the civitai file's "
        f"{len(civitai_kept)}/2 checked; launches {launches}")
    missing = [n for n in KERNELS if launches[n] == 0]
    if (len(run["losses"]) != steps or not all(math.isfinite(x) for x in run["losses"])
            or still or len(civitai_kept) != 2 or missing):
        raise RuntimeError(f"civitai training: losses {run['losses']}, not moved {still[:5]}, "
                           f"kernels not launched {missing}")
    del run, now
    torch.cuda.empty_cache()

    # (f) the FLOPs of one UNet call of the sampler, over phase 5's median step
    t0 = time.perf_counter()
    flops = unet_apply_flops(4, 16, 32)
    log(f"[civitai] (f) unet_apply_flops(4, 16, 32) on meta: {flops:.0f} FLOPs "
        f"({time.perf_counter() - t0:.1f} s to count); over phase 5's median UNet step "
        f"{unet_ms:.1f} ms: {flops / (unet_ms / 1e3) / 1e12:.1f} TFLOP/s achieved, "
        f"{flops / (unet_ms / 1e3) / 989e12:.1%} of the bf16 peak of ops/work.py; card {smi}")

    return out


def _wrappers():
    """The op wrappers that launch each kernel; each carries its count."""
    from cvd_tpu_torch.ops import counted_wrappers

    return counted_wrappers()


def _slice_argv(out_root):
    """Phase 5's request: ``cli.inference`` at SD1.5 width, bf16, 256 px, 16
    frames, 3 steps, the two prompts of assets/example_prompts.json."""
    assets = os.path.join(HERE, "assets")
    return ["--random-weights-full", "--bf16", "--image_height", "256", "--image_width", "256",
            "--video_length", "16", "--num_inference_steps", "3",
            "--caption_file", os.path.join(assets, "example_prompts.json"),
            "--use_negative_prompt",
            "--pose_file_0", os.path.join(assets, "pose_files", "example_dolly.txt"),
            "--pose_file_1", os.path.join(assets, "pose_files", "example_arc.txt"),
            "--out_root", out_root]


def _nview_argv(out_root):
    """Phase 6's request: ``cli.inference_advanced`` at SD1.5 width, bf16, 256
    px, 16 frames, 4 views, 3 steps, multistep 2, accumulate 2, the first
    prompt (written to ``out_root``)."""
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(HERE, "assets", "example_prompts.json")) as f:
        prompts = json.load(f)
    one_prompt = os.path.join(out_root, "prompt.json")
    with open(one_prompt, "w") as f:
        json.dump({"captions": prompts["captions"][:1],
                   "negative_prompts": prompts["negative_prompts"][:1]}, f)
    return ["--random-weights-full", "--bf16", "--image_height", "256", "--image_width", "256",
            "--video_length", "16", "--view_num", "4", "--cam_pattern", "circle",
            "--num_inference_steps", "3", "--multistep", "2", "--accumulate_step", "2",
            "--caption_file", one_prompt, "--use_negative_prompt", "--out_root", out_root]


def phase_slice(torch):
    """-> (launches, UNet calls run (warm-ups included), median steady step
    ms, the requests' videos, the requests' records)."""
    import numpy as np

    from cvd_tpu_torch.cli import inference

    args = inference.build_parser().parse_args(
        _slice_argv(os.path.join(HERE, "build", "chip_smoke_out")))
    wrappers = _wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    k5 = wrappers["layer_norm_matmul"]
    k5.routes = dict.fromkeys(k5.routes, 0)
    t0 = time.perf_counter()
    records = inference.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, rec in enumerate(records):
        v = rec["videos"]
        if v.shape != (2, 16, 256, 256, 3) or not np.isfinite(v).all():
            raise RuntimeError(f"request {i}: videos {v.shape}, finite={np.isfinite(v).all()}")
        steps = ", ".join(f"{ms:.1f}" for ms in rec["unet_step_ms"])
        prog = rec["program"]
        log(f"[slice] request {i}: {rec['seconds']:.2f} s end to end, UNet steps [{steps}] ms, "
            f"video std {float(v.std()):.4f}; captured {prog['captured']}, "
            f"{prog['captures']} capture(s) in {prog['capture_s']:.2f} s, warm-up UNet calls "
            f"{prog['warmup_calls']}")
    log(f"[slice] 2 requests in {seconds:.2f} s (module build included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {launches}, K5's "
        f"{launches['layer_norm_matmul']} by route {k5.routes}")
    missing = [n for n in FORWARD if launches[n] == 0]
    if len(records) != 2 or missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    if not all(rec["program"]["captured"] for rec in records):
        raise RuntimeError("the 2-view CLI did not replay its timesteps as CUDA graphs")
    unet_steps = sum(len(rec["unet_step_ms"]) + rec["program"]["warmup_calls"]
                     for rec in records)
    steady = [ms for rec in records for ms in rec["unet_step_ms"][1:]]
    return (launches, unet_steps, float(np.median(steady)), [rec["videos"] for rec in records],
            records)


def phase_nview(torch):
    """``cvd_tpu_torch.cli.inference_advanced`` at SD1.5 width: 4 views, 256 px,
    16 frames, bf16, 3 DDIM steps, multistep 2, accumulate_step 2, the first
    prompt of assets/example_prompts.json; as a loop (10 UNet calls at 8 CFG
    rows), then with ``accumulate_batched`` (5 calls at 16 rows).
    -> ({variant: (launches, UNet calls run, warm-ups included)},
    {variant: videos}, {variant: the request's record})."""
    import numpy as np

    from cvd_tpu_torch.cli import inference_advanced
    from cvd_tpu_torch.models import epi

    args = inference_advanced.build_parser().parse_args(
        _nview_argv(os.path.join(HERE, "build", "chip_smoke_nview")))

    # what K1 is handed: count the calls whose route is not the 2-view half swap
    kernel, other_routes = epi.epi_flash_attention, []

    def watched(q, k, v, *geom, heads, kv_index):
        B = q.shape[0]
        half_swap = (torch.arange(B, device=q.device, dtype=torch.int32) + B // 2) % B
        other_routes.append((kv_index != half_swap).any())
        return kernel(q, k, v, *geom, heads=heads, kv_index=kv_index)

    wrappers = _wrappers()
    results, videos, records = {}, {}, {}
    epi.epi_flash_attention = watched
    try:
        for variant, batched, calls, rows in (("loop", False, 10, 8), ("batched", True, 5, 16)):
            other_routes.clear()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            (rec,) = inference_advanced.main(args, accumulate_batched=batched)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in wrappers.items()}
            peak = torch.cuda.max_memory_allocated()
            v, ms, prog = rec["videos"], rec["unet_step_ms"], rec["program"]
            # K1's calls in Python: the warm-ups' and the captures' (a replay
            # runs no Python; a captured check holds its last replay's value)
            routed = int(torch.stack(other_routes).sum()) if other_routes else 0
            run = len(ms) + prog["warmup_calls"]
            log(f"[nview] {variant}: captured {prog['captured']}, {prog['captures']} graph(s) "
                f"captured in {prog['capture_s']:.2f} s, warm-up UNet calls "
                f"{prog['warmup_calls']}")
            log(f"[nview] {variant}: 4 views, {len(ms)} UNet calls at {rows} CFG rows x 16 frames: "
                f"{rec['seconds']:.2f} s the request ({seconds:.2f} s with the module build), "
                f"UNet calls [{', '.join(f'{x:.1f}' for x in ms)}] ms, steady "
                f"{sorted(ms[1:])[len(ms[1:]) // 2]:.1f} ms (median after the first), "
                f"peak allocated {peak / 2**30:.2f} GiB, video std {float(v.std()):.4f}")
            log(f"[nview] {variant}: launches {launches}; per UNet call run (warm-ups "
                f"included) { {n: round(launches[n] / run, 1) for n in FORWARD} } (K4 includes "
                f"the pose encoder and the VAE decode); K1 calls in Python with a route other "
                f"than the half swap {routed}/{len(other_routes)}")
            missing = [n for n in FORWARD if launches[n] == 0]
            if (v.shape != (4, 16, 256, 256, 3) or not np.isfinite(v).all() or len(ms) != calls
                    or missing or routed == 0 or not prog["captured"]):
                raise RuntimeError(f"N-view {variant}: videos {v.shape}, finite "
                                   f"{np.isfinite(v).all()}, {len(ms)} UNet calls (want {calls}), "
                                   f"kernels not launched {missing}, K1 calls off the half swap "
                                   f"{routed}")
            results[variant] = (launches, run)
            videos[variant] = v
            records[variant] = rec
    finally:
        epi.epi_flash_attention = kernel
    return results, videos, records


class _DrawLog:
    """Every random draw of a sampler on the card, recorded where it is
    drawn: the epi slopes (``models.epi._uniform_slope``), the pairings
    (``pipelines.advanced.random_pairing``) and the noises (the first 8
    values of each ``AdvancedPipeline.draw_noise``). Each draw is written
    into a buffer on the card at a counter on the card, so that a CUDA
    graph's replays write their own draws. The warm-up before a capture
    (eager, on a side stream; its draws are given back) is not recorded."""

    def __init__(self, torch, size=8192):
        self.torch = torch
        self.count = torch.zeros(1, dtype=torch.long, device="cuda")
        self.rows = torch.full((size, 9), float("nan"), device="cuda")

    def _record(self, kind, x):
        torch = self.torch
        if (not torch.cuda.is_current_stream_capturing()
                and torch.cuda.current_stream() != torch.cuda.default_stream()):
            return
        # built on the card: a number written into a card tensor would be a
        # copy from the host, which a capture refuses
        x = x.reshape(-1)[:8].float().to("cuda")
        row = torch.cat([torch.full((1,), float(kind), device="cuda"), x,
                         torch.full((8 - x.numel(),), float("nan"), device="cuda")])
        self.rows.index_copy_(0, self.count, row[None])
        self.count += 1

    def __enter__(self):
        from cvd_tpu_torch.models import epi
        from cvd_tpu_torch.pipelines import advanced

        self.saved = (epi._uniform_slope, advanced.random_pairing,
                      advanced.AdvancedPipeline.draw_noise)
        slope, pairing, noise = self.saved

        def slope_(*a, **kw):
            out = slope(*a, **kw)
            self._record(0, out)
            return out

        def pairing_(*a, **kw):
            out = pairing(*a, **kw)
            self._record(1, out)
            return out

        def noise_(pipe, *a, **kw):
            out = noise(pipe, *a, **kw)
            self._record(2, out)
            return out

        epi._uniform_slope, advanced.random_pairing = slope_, pairing_
        advanced.AdvancedPipeline.draw_noise = noise_
        return self

    def __exit__(self, *exc):
        from cvd_tpu_torch.models import epi
        from cvd_tpu_torch.pipelines import advanced

        (epi._uniform_slope, advanced.random_pairing,
         advanced.AdvancedPipeline.draw_noise) = self.saved

    def draws(self):
        """-> [n, 9] on the host: kind (0 slope, 1 pairing, 2 noise), values."""
        n = int(self.count)
        if n >= self.rows.shape[0]:
            raise RuntimeError(f"{n} draws overflow the log of {self.rows.shape[0]}")
        return self.rows[:n].cpu().numpy()


def _loop_per_call(records):
    """Launches per UNet call of the records' denoising loops (the
    program's count around its bodies or replays, warm-ups apart)."""
    calls = sum(r["program"]["unet_calls"] for r in records)
    return {n: sum(r["program"]["launches"][n] for r in records) / calls for n in FORWARD}


def _graphs_turns(torch, np):
    """Phase graphs (f): captured and eager requests in turns at the
    pipelines, from one build (SD1.5 width, bf16, random weights, 256 px, 16
    frames): 2 views (4 CFG rows, 3 steps), 4 views as a loop (8 rows) and
    batched (16 rows; 3 steps, multistep 2, accumulate 2). -> {path: dict}."""
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.models.vae import VAEConfig
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    modules = PipelineModules.create(UNetConfig(), VAEConfig(), CLIPTextConfig(), device="cuda",
                                     dtype=torch.bfloat16, random_full=True,
                                     generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    ids = dict(prompt_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
               negative_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))))
    plucker, c2w, K = _nview_cameras(np, torch, 4, 16, 256)
    two = dict(ids, plucker=torch.from_numpy(rng.standard_normal((2, 16, 256, 256, 6))
                                             .astype(np.float32)),
               F_mats=torch.from_numpy((rng.standard_normal((2, 16, 3, 3)) * 1e-3)
                                       .astype(np.float32)), num_inference_steps=3)
    four = dict(ids, plucker=plucker, c2w=c2w, K_mats=K, num_inference_steps=3, multistep=2,
                accumulate_step=2)
    paths = (("2view", 4, lambda c: SimplePipeline(modules, capture=c), two, 3),
             ("4view_loop", 8, lambda c: AdvancedPipeline(modules, capture=c), four, 2),
             ("4view_batched", 16, lambda c: AdvancedPipeline(modules, accumulate_batched=True,
                                                              capture=c), four, 2))
    out = {}
    for path, rows, make, inputs, turns in paths:
        pipes = {True: make(True), False: make(False)}
        runs = {True: [], False: []}
        for captured in [True, False] * turns:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipes[captured](**inputs, generator=torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            pipe = pipes[captured]
            runs[captured].append(dict(
                seconds=time.perf_counter() - t0, ms=list(pipe.unet_step_ms),
                peak=torch.cuda.max_memory_allocated() / 2**30,
                reserved=torch.cuda.memory_reserved() / 2**30,
                capture_s=pipe.program.stats["capture_s"],
                captured=pipe.program.stats["captured"]))
        if not all(r["captured"] for r in runs[True]) or any(r["captured"] for r in runs[False]):
            raise RuntimeError(f"(f) {path}: captured / eager runs not as asked")
        first, steady = runs[True][0], runs[True][1:]
        rec = dict(
            rows=rows,
            captured_ms=float(np.median([x for r in steady for x in r["ms"]])),
            eager_ms=float(np.median([x for r in runs[False] for x in r["ms"]])),
            captured_s=[r["seconds"] for r in runs[True]],
            eager_s=[r["seconds"] for r in runs[False]],
            capture_s=first["capture_s"], first_request_s=first["seconds"],
            captured_peak_gib=max(r["peak"] for r in runs[True]),
            eager_peak_gib=max(r["peak"] for r in runs[False]),
            reserved_gib=max(r["reserved"] for r in runs[True] + runs[False]))
        log(f"[graphs] (f) {path}, {rows} CFG rows: a UNet call captured {rec['captured_ms']:.1f} "
            f"ms vs eager {rec['eager_ms']:.1f} ms (medians; captured after its first request); "
            f"s a request captured [{', '.join(f'{x:.3f}' for x in rec['captured_s'])}] vs "
            f"eager [{', '.join(f'{x:.3f}' for x in rec['eager_s'])}] (in turns, captured "
            f"first); the first request's warm-ups and captures {rec['capture_s']:.2f} s; peak "
            f"allocated captured {rec['captured_peak_gib']:.2f} GiB vs eager "
            f"{rec['eager_peak_gib']:.2f} GiB, reserved {rec['reserved_gib']:.2f} GiB")
        out[path] = rec
        del pipes
        torch.cuda.empty_cache()
    del modules
    torch.cuda.empty_cache()
    return out


def phase_graphs(torch, slice_videos, slice_records, nview_videos, nview_records):
    """Phase graphs (the module docstring): the samplers' timesteps as
    replayed CUDA graphs against the same requests run eagerly. Raises on a
    failed check. -> {path: (launches, UNet calls)} of its CLI runs, and
    (f)'s times."""
    import numpy as np

    from cvd_tpu_torch.cli import inference, inference_advanced

    wrappers = _wrappers()
    out = {}

    def cli(name, module, argv, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        records = module.main(module.build_parser().parse_args(argv), **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in wrappers.items()}
        calls = sum(len(r["unet_step_ms"]) + r["program"]["warmup_calls"] for r in records)
        out[name] = (launches, calls)
        prog = [r["program"] for r in records]
        log(f"[graphs] {name}: {len(records)} request(s) in {seconds:.2f} s with the build, "
            f"{', '.join(f'{r['seconds']:.2f}' for r in records)} s a request, captured "
            f"{[p['captured'] for p in prog]}, graphs captured {[p['captures'] for p in prog]}, "
            f"UNet calls {[p['unet_calls'] for p in prog]}")
        missing = [n for n in FORWARD if launches[n] == 0]
        if missing:
            raise RuntimeError(f"{name}: kernels not launched {missing}")
        return records

    def same(what, got, want):
        equal = [np.array_equal(g, w) for g, w in zip(got, want)]
        diff = [float(np.abs(g.astype(np.float64) - w).max()) for g, w in zip(got, want)]
        log(f"[graphs] {what}: bit for bit {equal} (max |diff| {diff})")
        if len(got) != len(want) or not all(equal):
            raise RuntimeError(f"{what}: not bit for bit ({diff})")

    # (a) phase 5's requests, eagerly
    t0 = time.perf_counter()
    eager2 = cli("eager_2view", inference,
                 _slice_argv(os.path.join(HERE, "build", "chip_smoke_graphs")), capture=False)
    same("(a) 2 views, phase 5's two requests captured against capture=False",
         slice_videos, [r["videos"] for r in eager2])
    log(f"[time] graphs (a): {time.perf_counter() - t0:.1f} s")

    # (b) phase 6's request eagerly, as a loop (its draws recorded) and batched
    t0 = time.perf_counter()
    argv = _nview_argv(os.path.join(HERE, "build", "chip_smoke_graphs_nview"))
    with _DrawLog(torch) as log_eager:
        (loop,) = cli("eager_4view_loop", inference_advanced, argv, capture=False)
    (batched,) = cli("eager_4view_batched", inference_advanced, argv, capture=False,
                     accumulate_batched=True)
    same("(b) 4 views, a loop: phase 6's request captured against capture=False",
         [nview_videos["loop"]], [loop["videos"]])
    same("(b) 4 views, batched: phase 6's request captured against capture=False",
         [nview_videos["batched"]], [batched["videos"]])
    log(f"[time] graphs (b): {time.perf_counter() - t0:.1f} s")

    # (c) --step_chunk 1 (its draws recorded), 2 and 3
    t0 = time.perf_counter()
    chunked = {}
    for k in (1, 2, 3):
        with (_DrawLog(torch) if k == 1 else contextlib.nullcontext()) as draws:
            (chunked[k],) = cli(f"step_chunk_{k}", inference_advanced,
                                argv + ["--step_chunk", str(k)])
        if k == 1:
            log_captured = draws
        prog = chunked[k]["program"]
        # 3 timesteps, multistep 2: repeats (2, 2, 1); the last timestep is its own graph
        want = {1: 2, 2: 2, 3: 1}[k]
        if not prog["captured"] or prog["captures"] != want:
            raise RuntimeError(f"--step_chunk {k}: captured {prog['captured']}, "
                               f"{prog['captures']} graphs (want {want})")
    same("(c) --step_chunk 1, 2 and 3 against each other and the eager loop",
         [chunked[k]["videos"] for k in (1, 2, 3)], [loop["videos"]] * 3)
    log(f"[time] graphs (c): {time.perf_counter() - t0:.1f} s")

    # (d) the draws: the captured request's equal to the eager one's, and fresh
    want, got = log_eager.draws(), log_captured.draws()
    slopes = got[got[:, 0] == 0, 1]
    pairings = got[got[:, 0] == 1, 1:5]
    n_kind = {k: int((got[:, 0] == k).sum()) for k in (0, 1, 2)}
    fresh_slopes = len(np.unique(slopes)) == len(slopes)
    fresh_pairings = len({tuple(p) for p in pairings}) > 1
    equal = want.shape == got.shape and np.array_equal(np.nan_to_num(want, nan=-9.0),
                                                       np.nan_to_num(got, nan=-9.0))
    log(f"[graphs] (d) draws recorded on the card: eager {len(want)}, captured {len(got)} "
        f"(slopes {n_kind[0]}, pairings {n_kind[1]}, noises {n_kind[2]}); equal draw for "
        f"draw: {equal}; every slope drawn once: {fresh_slopes} ({len(np.unique(slopes))} "
        f"distinct); pairings not all one: {fresh_pairings}")
    if not (equal and fresh_slopes and fresh_pairings and n_kind[0] and n_kind[1]):
        raise RuntimeError("(d) the captured request's draws are not the eager request's, or "
                           "a replay repeated its draws")

    # (e) launches per UNet call of the denoising loop, captured against eager
    pairs = (("2view", slice_records, eager2), ("4view_loop", [nview_records["loop"]], [loop]),
             ("4view_batched", [nview_records["batched"]], [batched]))
    per_call = {}
    for path, captured, eager in pairs:
        c, e = _loop_per_call(captured), _loop_per_call(eager)
        per_call[path] = (c, e)
        log(f"[graphs] (e) {path}: launches per UNet call captured "
            f"{ {n: round(v, 2) for n, v in c.items()} } vs eager "
            f"{ {n: round(v, 2) for n, v in e.items()} }")
        if c != e:
            raise RuntimeError(f"(e) {path}: launches per UNet call differ")

    # (f) times, in turns
    t0 = time.perf_counter()
    turns = _graphs_turns(torch, np)
    log(f"[time] graphs (f): {time.perf_counter() - t0:.1f} s")
    return out, per_call, turns


class _TorchrunEnv:
    """torchrun's variables for a world of one (a free port) inside a
    ``with`` block; what they replaced comes back after it."""

    def __enter__(self):
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        self.saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sharded_run(torch, wrappers, cli, argv, unsharded, what, calls_per_request, **kw):
    """One ``--sharded`` entry-point run, counted from 0: its videos against
    ``unsharded`` (a list, one a request) bit for bit. -> (launches, UNet calls)."""
    import numpy as np

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    records = cli.main(cli.build_parser().parse_args(argv + ["--sharded", "--device", "cuda"]),
                       **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    calls = sum(len(rec["unet_step_ms"]) for rec in records)
    equal = [np.array_equal(rec["videos"], v) for rec, v in zip(records, unsharded)]
    ms = [x for rec in records for x in rec["unet_step_ms"]]
    per_request = ", ".join(f"{rec['seconds']:.2f}" for rec in records)
    log(f"[mesh] {what}: {len(records)} request(s) in {seconds:.2f} s with the build, "
        f"{per_request} s a request, UNet calls "
        f"[{', '.join(f'{x:.1f}' for x in ms)}] ms, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per UNet call "
        f"{ {n: round(launches[n] / calls, 1) for n in FORWARD} }; videos bit for bit those "
        f"of the unsharded run: {equal}")
    missing = [n for n in FORWARD if launches[n] == 0]
    if (len(records) != len(unsharded) or not all(equal) or missing
            or calls != calls_per_request * len(records)):
        raise RuntimeError(f"{what}: videos equal {equal}, kernels not launched {missing}, "
                           f"{calls} UNet calls")
    return launches, calls


def phase_mesh(torch, slice_videos, nview_videos):
    """(a) K1 and K3 at the sharded shapes (``_mesh_cases``); (b)
    ``cli.inference --sharded`` as a world of one over NCCL at phase 5's size;
    (c) ``cli.inference_advanced --sharded`` at phase 6's, as a loop and
    batched: the videos bit for bit those of phases 5 and 6 (a world of one
    shards nothing). The three runs share one NCCL group, destroyed at the
    end. -> (the kernel report of (a), {path: (launches, UNet calls)})."""
    import torch.distributed as dist

    from cvd_tpu_torch.cli import inference, inference_advanced
    from cvd_tpu_torch.parallel.mesh import init_distributed

    t0 = time.perf_counter()
    report = phase_kernels(torch, mesh=True)
    log(f"[time] mesh (a): {time.perf_counter() - t0:.1f} s")
    wrappers = _wrappers()
    out = {}
    with _TorchrunEnv():
        init_distributed("cuda", "--sharded", "chip_smoke.py")
        try:
            t0 = time.perf_counter()
            out["sampler"] = _sharded_run(
                torch, wrappers, inference,
                _slice_argv(os.path.join(HERE, "build", "chip_smoke_mesh")), slice_videos,
                "(b) cli.inference --sharded, a world of one", 3)
            log(f"[time] mesh (b): {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            argv = _nview_argv(os.path.join(HERE, "build", "chip_smoke_mesh_nview"))
            for variant, batched, calls in (("loop", False, 10), ("batched", True, 5)):
                out[f"nview_{variant}"] = _sharded_run(
                    torch, wrappers, inference_advanced, argv, [nview_videos[variant]],
                    f"(c) cli.inference_advanced --sharded, a world of one, {variant}", calls,
                    accumulate_batched=batched)
            log(f"[time] mesh (c): {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
    return report, out


MESHES = ((4, 1), (2, 2), (1, 4))


def _narrow_mesh_runs(torch, np, rank):
    """The narrow model (f32, TF32 off, every tensor drawn) at 256 px, 4
    frames, 2 steps: the 2-view sampler and the 4-view sampler (multistep 2,
    accumulate 2, fix_firstframe) as a loop and batched, on one card (rank
    0) and sharded over each of ``MESHES``: >= 60 dB, bit-equal on every rank."""
    import torch.distributed as dist

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.parallel.mesh import create_mesh, replicate
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device=dev,
                               generator=torch.Generator().manual_seed(0), random_full=True)
    rng = np.random.default_rng(0)
    V, Fr, S = 4, 4, 256
    ids = dict(prompt_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
               negative_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
               num_inference_steps=2, decode=False)
    two = dict(ids, plucker=torch.from_numpy(rng.standard_normal((2, Fr, S, S, 6)).astype(
        np.float32)), F_mats=torch.from_numpy((rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(
            np.float32)), latents=torch.from_numpy(rng.standard_normal(
                (2, Fr, S // 8, S // 8, 4)).astype(np.float32)))
    plucker, c2w, K = _nview_cameras(np, torch, V, Fr, S)
    nview = dict(ids, plucker=plucker, c2w=c2w, K_mats=K, multistep=2, accumulate_step=2)

    def run(name, mesh=None):
        if name == "2-view":
            return SimplePipeline(m, F_mat_size=S, rand_slope_ff=False, mesh=mesh)(**two)
        pipe = AdvancedPipeline(m, F_mat_size=S, rand_slope_ff=False, fix_firstframe=True,
                                accumulate_batched=name.endswith("batched"), mesh=mesh)
        return pipe(**nview, generator=torch.Generator().manual_seed(7))

    names = ("2-view", "4-view loop", "4-view batched")
    with torch.no_grad():
        want = {n: run(n).cpu().numpy() for n in names} if rank == 0 else {}
        for shape in MESHES:
            mesh = create_mesh(shape, ("rows", "frames"))
            replicate(m.unet, mesh)
            for n in names:
                got = run(n, mesh)
                every = [torch.empty_like(got) for _ in range(mesh.size)]
                dist.all_gather(every, got)
                same = all(torch.equal(e, got) for e in every)
                if rank == 0:
                    snr = _snr_db(np, want[n], got.cpu().numpy())
                    log(f"[mesh4] narrow f32 {n}, mesh {shape}: against one card "
                        f"{snr:.1f} dB, bit-equal on the 4 ranks: {same}")
                    if not (snr >= 60.0 and same):
                        raise RuntimeError(f"narrow {n} on {shape}: {snr:.1f} dB, same {same}")


def _call_times(np, records) -> str:
    """s a request, the first UNet call and the median of the others."""
    ms = [x for rec in records for x in rec["unet_step_ms"]]
    per_request = ", ".join(f"{rec['seconds']:.2f}" for rec in records)
    return (f"{per_request} s a request, first UNet call {ms[0]:.1f} ms, median after it "
            f"{float(np.median(ms[1:])):.1f} ms")


def _sd15_mesh_runs(torch, np, rank):
    """The two CLIs at SD1.5 width (bf16) with ``--sharded`` on their own mesh
    (4 cards: (4, 1)) against the same requests on one card (rank 0): s a
    request, ms a UNet call (the first apart, the median after it), peak GiB
    on each card, PSNR of the videos (``cli/eval_parity.psnr``)."""
    import torch.distributed as dist

    from cvd_tpu_torch.cli import eval_parity, inference, inference_advanced

    runs = (("2-view", inference, _slice_argv, {}),
            ("4-view loop", inference_advanced, _nview_argv, {"accumulate_batched": False}),
            ("4-view batched", inference_advanced, _nview_argv, {"accumulate_batched": True}))
    one = {}
    if rank == 0:
        for name, cli, argv, kw in runs:
            records = cli.main(cli.build_parser().parse_args(
                argv(os.path.join(HERE, "build", "mesh4_one")) + ["--device", "cuda:0"]), **kw)
            one[name] = records
            log(f"[mesh4] SD1.5 {name} on one card: {_call_times(np, records)}")
            torch.cuda.empty_cache()
    for name, cli, argv, kw in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        records = cli.main(cli.build_parser().parse_args(
            argv(os.path.join(HERE, "build", f"mesh4_rank{rank}")) + ["--sharded", "--device",
                                                                      "cuda"]), **kw)
        torch.cuda.synchronize()
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 2 ** 30)
        if rank == 0:
            # PSNR per view and frame, averaged over the request
            psnr = [float(np.mean([eval_parity.psnr(a, b) for a, b in
                                   zip(r["videos"].reshape((-1,) + r["videos"].shape[2:]),
                                       o["videos"].reshape((-1,) + o["videos"].shape[2:]))]))
                    for r, o in zip(records, one[name])]
            peak = ", ".join(f"{p:.2f}" for p in peaks)
            log(f"[mesh4] SD1.5 {name} --sharded on mesh {{'rows': 4, 'frames': 1}}: "
                f"{_call_times(np, records)}, peak allocated per card [{peak}] GiB, PSNR "
                f"against one card {', '.join(f'{p:.2f}' for p in psnr)} dB")
            if not all(np.isfinite(r["videos"]).all() for r in records):
                raise RuntimeError(f"SD1.5 {name}: videos not finite")
        torch.cuda.empty_cache()


def mesh_worker() -> int:
    """One of the four processes of ``--mesh`` (started by torchrun)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from cvd_tpu_torch.parallel.mesh import init_distributed

    rank, world, _ = init_distributed("cuda", "--mesh", "chip_smoke.py")
    try:
        t0 = time.perf_counter()
        _narrow_mesh_runs(torch, np, rank)
        if rank == 0:
            log(f"[time] mesh4 narrow: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _sd15_mesh_runs(torch, np, rank)
        if rank == 0:
            log(f"[time] mesh4 SD1.5: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    return 0


def mesh_cards(torch) -> None:
    """``--mesh``: four processes over four cards (torchrun), ``mesh_worker``
    in each; raises unless all four end with 0."""
    import signal
    import socket

    n = torch.cuda.device_count()
    if n < 4:
        raise RuntimeError(f"--mesh needs 4 cards, {n} visible")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
           "--master_addr", "localhost", "--master_port", str(port),
           os.path.join(HERE, "chip_smoke.py"), "--mesh-worker"]
    proc = subprocess.Popen(cmd, cwd=HERE, start_new_session=True)
    try:
        rc = proc.wait(timeout=1100)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc != 0:
        raise RuntimeError(f"--mesh: torchrun ended with {rc}")


def _profile_nview(torch):
    """torch.profiler over the N-view sampler's UNet calls at SD1.5 width in
    bf16 (4 views, 16 frames, 256 px, accumulate_step 2, no decode), after a
    warm-up run: 4 calls at 8 CFG rows (the loop), then 2 at 16 (batched)."""
    import numpy as np

    from cvd_tpu_torch.models.clip_text import CLIPTextConfig
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.models.vae import VAEConfig
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.utils.profiling import trace

    modules = PipelineModules.create(UNetConfig(), VAEConfig(), CLIPTextConfig(), device="cuda",
                                     dtype=torch.bfloat16, random_full=True,
                                     generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    plucker, c2w, K = _nview_cameras(np, torch, 4, 16, 256)
    inputs = dict(
        prompt_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        negative_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        plucker=plucker, c2w=c2w, K_mats=K, num_inference_steps=2, multistep=1,
        accumulate_step=2, decode=False, generator=torch.Generator(device="cuda").manual_seed(0))
    for (batched, calls, rows), capture in itertools.product(
            ((False, 4, 8), (True, 2, 16)), (False, True)):
        mode = "captured" if capture else "eager"
        pipe = AdvancedPipeline(modules, accumulate_batched=batched, capture=capture)
        pipe(**inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with trace(_profile_dir(f"nview_{rows}rows_{mode}")) as prof:
            t0 = time.perf_counter()
            pipe(**inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if len(pipe.unet_step_ms) != calls:
            raise RuntimeError(f"{len(pipe.unet_step_ms)} UNet calls profiled, expected {calls}")
        log(f"[profile] N-view sampler at {rows} CFG rows, {mode}, no decode: peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        _report_profile(prof, wall, calls, f"N-view sampler, bf16 UNet calls at {rows} CFG rows, "
                        f"{mode} (text and pose encoders included once)",
                        f"nview_{rows}rows_{mode}_profile.txt")
    del modules, pipe
    torch.cuda.empty_cache()


class _SeededPairs:
    """In-memory folded pairs with the sample keys of RealEstate10KPoseFolded:
    Plücker maps and F mats of assets/pose_files/example_{dolly,arc}.txt
    (data/validation.py), pixels uniform in [-1, 1] from the item's seed,
    captions from assets/example_prompts.json."""

    def __init__(self, n_items: int, n_frames: int, size: int, seed: int = 0):
        import numpy as np

        from cvd_tpu_torch.cli.inference import load_prompts
        from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded

        assets = os.path.join(HERE, "assets")
        self.captions = load_prompts(os.path.join(assets, "example_prompts.json"), False)[0]
        cams = ValRealEstate10KPoseFolded(
            self.captions, os.path.join(assets, "pose_files", "example_dolly.txt"),
            os.path.join(assets, "pose_files", "example_arc.txt"),
            sample_n_frames=n_frames, sample_size=size)[0]
        self.plucker = cams["plucker_embedding"].astype(np.float32)   # [2n, S, S, 6]
        self.F_mats = cams["F_mats"].astype(np.float32)               # [2n, 3, 3]
        self.poses = {k: cams[k].astype(np.float32) for k in ("ret_c2w", "ret_K_mats")}
        self.n_items, self.shape, self.seed = n_items, (2 * n_frames, size, size, 3), seed

    def __len__(self):
        return self.n_items

    def __getitem__(self, i):
        import numpy as np

        rng = np.random.default_rng(self.seed + int(i))
        return {"pixel_values": rng.uniform(-1.0, 1.0, self.shape).astype(np.float32),
                "text": self.captions[int(i) % len(self.captions)],
                "plucker_embedding": self.plucker, "F_mats": self.F_mats, **self.poses}


def phase_train(torch):
    """cli.train.run at SD1.5 width, then one step with remat off."""
    import numpy as np

    from cvd_tpu_torch.cli import train
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import train_step

    steps, n_frames, size = 4, 16, 256
    cfg = dict(random_weights_full=True, bf16=True, sample_size=size, sample_n_frames=n_frames,
               train_batch_size=1, max_train_steps=steps, num_workers=2, remat=True,
               do_sanity_check=True, logger_interval=1, checkpointing_steps=10 ** 9,
               output_dir=os.path.join(HERE, "build", "chip_smoke_train"), global_seed=42)
    data = _SeededPairs(steps, n_frames, size)
    wrappers = _wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = train.run(cfg, sources=[data])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    state, modules, losses, secs = out["state"], out["modules"], out["losses"], out["step_seconds"]
    program = out["program"]
    log(f"[train] {steps} steps in {seconds:.2f} s (module build included), replayed as CUDA "
        f"graphs: {program['captured']} ({program['captures']} capture of "
        f"{program['capture_s']:.2f} s after the first step, which runs eagerly): losses "
        f"[{', '.join(f'{x:.5f}' for x in losses)}], s/step first {secs[0]:.3f} steady "
        f"[{', '.join(f'{x:.3f}' for x in secs[1:])}], peak allocated {peak / 2**30:.2f} GiB "
        f"(remat on), launches {launches}")
    if not program["captured"] or program["captures"] != 1:
        raise RuntimeError(f"the training run on the card did not replay one graph: {program}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"train losses {losses}")
    missing = [n for n in KERNELS if launches[n] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the training path: {missing}")

    # trainable weights moved, frozen ones bit-identical: against the same
    # seeded initial weights, built again
    init, _ = train.build_training_modules(cfg, torch.device("cuda"))
    create_train_state(init.unet, frozen_dtype=torch.bfloat16)
    now = dict(state.model.named_parameters())
    trainable = set(state.trainable)
    moved = sum(not torch.equal(p, now[n]) for n, p in init.unet.named_parameters()
                if n in trainable)
    frozen_changed = [n for n, p in init.unet.named_parameters()
                      if n not in trainable and not torch.equal(p, now[n])]
    log(f"[train] trainable tensors moved {moved}/{len(trainable)}, frozen tensors changed "
        f"{len(frozen_changed)}/{len(now) - len(trainable)}")
    if moved != len(trainable) or frozen_changed:
        raise RuntimeError(f"trainable moved {moved}/{len(trainable)}; frozen changed "
                           f"{frozen_changed[:5]}")
    del init

    # one more step with remat off, for its peak memory
    batch = _folded(torch, np, data, n_frames)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            m = train_step(state, batch, modules, gen, F_mat_size=size, remat=remat)
            torch.cuda.synchronize()
            log(f"[train] one step remat={remat}: {time.perf_counter() - t0:.3f} s, loss "
                f"{m['loss']:.5f}, peak allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        except torch.cuda.OutOfMemoryError:
            state.zero_grad()
            log(f"[train] one step remat={remat}: out of memory on the card")
    return launches, steps, secs[1:]


class _SeededFrames:
    """In-memory unposed clips: frames uniform in [-1, 1] from the item's
    seed made into a pseudo-pair by the port's homography pair-maker
    (``data.webvid.homography_pair``, the homography from ``random.Random``
    of the item), captions from assets/example_prompts.json."""

    def __init__(self, n_items: int, n_frames: int, size: int, seed: int = 100):
        from cvd_tpu_torch.cli.inference import load_prompts

        self.captions = load_prompts(os.path.join(HERE, "assets", "example_prompts.json"),
                                     False)[0]
        self.n_items, self.shape, self.seed = n_items, (n_frames, size, size, 3), seed

    def __len__(self):
        return self.n_items

    def __getitem__(self, i):
        import random

        import numpy as np

        from cvd_tpu_torch.data.webvid import homography_pair

        rng = np.random.default_rng(self.seed + int(i))
        frames = rng.uniform(-1.0, 1.0, self.shape).astype(np.float32)
        return {**homography_pair(frames, random.Random(self.seed + int(i))),
                "text": self.captions[int(i) % len(self.captions)]}


def _unposed_batch(torch, np, Fr, S, seed):
    """A pre-encoded unposed training batch: latents, text ids, the H mats of
    one random homography (H, then H^-1), warped masks."""
    import random

    from cvd_tpu_torch.data.webvid import random_homography

    rng = np.random.default_rng(seed)
    H = random_homography(random.Random(seed), S)
    H_mats = np.stack([H] * Fr + [np.linalg.inv(H)] * Fr).astype(np.float32)
    return {
        "latents": torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4))
                                    .astype(np.float32)),
        "text_ids": torch.from_numpy(rng.integers(0, 49408, (2, 77))),
        "H_mats": torch.from_numpy(H_mats.reshape(2, Fr, 3, 3)),
        "warped_masks": torch.from_numpy((rng.random((2, Fr, S // 8, S // 8, 1)) > 0.2)
                                         .astype(np.float32)),
    }


def _training_reference(torch, np):
    """(a) one unposed step of the narrow UNet (with an image LoRA, which
    runs at scale 0) at 256 px, card vs CPU from the same weights, batch,
    noise, timesteps and per-row slopes, remat on."""
    import dataclasses

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Fr, S = 2, 256
    batch = _unposed_batch(torch, np, Fr, S, seed=4)
    rng = np.random.default_rng(5)
    pinned = dict(noise=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4))
                                         .astype(np.float32)),
                  timesteps=torch.from_numpy(np.array([333, 912])),
                  slope=torch.from_numpy(rng.uniform(0, np.pi, 2 * Fr).astype(np.float32)),
                  F_mat_size=S, remat=True)
    unet_cfg = dataclasses.replace(SMOKE_UNET, spatial_lora_rank=2)
    cpu = PipelineModules.create(unet_cfg, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                 generator=torch.Generator().manual_seed(6), random_full=True)
    gpu = PipelineModules.create(unet_cfg, SMOKE_VAE, SMOKE_CLIP, device="cuda")
    for name in ("unet", "clip", "pose_encoder"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    wrappers = _wrappers()
    results = []
    for m in (cpu, gpu):
        before = {n: fn.launches for n, fn in wrappers.items()}
        state = create_train_state(m.unet)
        loss, _ = loss_and_grads(state, batch, m, **pinned)
        params = dict(m.unet.named_parameters())
        grads = {n: params[n].grad.detach().cpu().numpy() for n in state.trainable}
        results.append((float(loss), grads,
                        sorted(n for n, fn in wrappers.items() if fn.launches > before[n])))
    (want_loss, want, _), (got_loss, got, used) = results
    ref = np.concatenate([want[n].ravel() for n in want])
    err = np.concatenate([got[n].ravel() for n in want]) - ref
    snr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))
    zero = sorted(n for n, g in got.items() if not np.any(g))
    rel = abs(got_loss - want_loss) / abs(want_loss)
    log(f"[training] (a) narrow UNet unposed step 256 px f32 (H mats, per-row slopes, warped "
        f"masks, image LoRA at scale 0), remat on: loss card {got_loss:.7f} CPU "
        f"{want_loss:.7f} (rel {rel:.1e}); trainable gradients ({len(want)} tensors) SNR "
        f"{snr:.1f} dB; zero on the card: {len(zero)} (kernels used: {', '.join(used)})")
    missing = [n for n in KERNELS if n not in used]
    if not (rel <= 1e-5 and snr >= 60.0) or zero or missing:
        raise RuntimeError(f"unposed train step card vs CPU: loss rel {rel:.1e}, SNR "
                           f"{snr:.1f} dB, zero gradients {zero[:5]}, kernels not launched "
                           f"{missing}")


def _training_hybrid(torch, np, wrappers):
    """(b) ``cli.train.run`` on hybrid data at SD1.5 width with process
    workers. -> (launches, steps, per-kind launches per step, the run's
    result)."""
    from cvd_tpu_torch.cli import train
    from cvd_tpu_torch.train.program import TrainProgram
    from cvd_tpu_torch.train.state import create_train_state

    steps, Fr, S = 4, 16, 256
    cfg = dict(random_weights_full=True, bf16=True, sample_size=S, sample_n_frames=Fr,
               train_batch_size=1, max_train_steps=steps, num_workers=2, worker_type="process",
               remat=True, do_sanity_check=True, logger_interval=1, checkpointing_steps=10 ** 9,
               global_seed=42, output_dir=os.path.join(HERE, "build", "chip_smoke_training"),
               train_data=dict(dataset_name="hybrid", posed_ratio=0.5))
    ratio = cfg["train_data"]["posed_ratio"]
    sources = [("posed", _SeededPairs(4, Fr, S), ratio),
               ("unposed", _SeededFrames(4, Fr, S), 1.0 - ratio)]
    per_kind = {"posed": [], "unposed": []}
    real = TrainProgram.step

    def watched(self, batch, *a, **kw):
        """the loop's steps, their launches and seconds kept per kind"""
        before = dict(self.stats["launches"])
        t0 = time.perf_counter()
        out = real(self, batch, *a, **kw)
        torch.cuda.synchronize()
        per_kind["unposed" if "H_mats" in batch else "posed"].append(
            (time.perf_counter() - t0,
             {n: c - before[n] for n, c in self.stats["launches"].items()}))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    TrainProgram.step = watched
    t0 = time.perf_counter()
    try:
        res = train.run(cfg, sources=sources)
    finally:
        TrainProgram.step = real
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses, kinds = res["losses"], res["kinds"]
    means = {}
    for kind, rows in per_kind.items():
        if rows:
            steady = sorted(t for t, _ in rows[1:]) or [rows[0][0]]
            means[kind] = {n: sum(c[n] for _, c in rows) / len(rows) for n in wrappers}
            log(f"[training] (b) {kind} steps: {len(rows)}, s/step "
                f"[{', '.join(f'{t:.3f}' for t, _ in rows)}] (median after the first "
                f"{steady[len(steady) // 2]:.3f} s), launches per step {means[kind]}")
    log(f"[training] (b) hybrid run (posed_ratio {ratio}) at SD1.5 width, bf16 frozen, {S} px, "
        f"{Fr} frames, remat on, process workers x{cfg['num_workers']}: {steps} steps in "
        f"{seconds:.2f} s (module build included), kinds {kinds}, losses "
        f"[{', '.join(f'{x:.5f}' for x in losses)}], peak allocated {peak / 2**30:.2f} GiB, "
        f"program {({k: v for k, v in res['program'].items() if 'launches' not in k})}, "
        f"launches {launches}")
    unposed = means.get("unposed", {})
    if (len(losses) != steps or not all(math.isfinite(x) for x in losses)
            or set(kinds) != {"posed", "unposed"} or not unposed
            or not res["program"]["captured"] or res["program"]["captures"] != 2
            or unposed["epi_flash_attention"] == 0 or unposed["epi_flash_attention_bwd"] == 0
            or [n for n in KERNELS if launches[n] == 0]):
        raise RuntimeError(f"hybrid run: losses {losses}, kinds {kinds}, unposed launches "
                           f"{unposed}, launches {launches}")
    # the frozen weights bit-identical to a fresh build's, the trainable ones moved
    init, _ = train.build_training_modules(cfg, torch.device("cuda"))
    create_train_state(init.unet, frozen_dtype=torch.bfloat16)
    now = dict(res["state"].model.named_parameters())
    trainable = set(res["state"].trainable)
    moved = sum(not torch.equal(p, now[n]) for n, p in init.unet.named_parameters()
                if n in trainable)
    changed = [n for n, p in init.unet.named_parameters()
               if n not in trainable and not torch.equal(p, now[n])]
    log(f"[training] (b) trainable tensors moved {moved}/{len(trainable)}, frozen tensors "
        f"changed {len(changed)}/{len(now) - len(trainable)}")
    del init
    if moved != len(trainable) or changed:
        raise RuntimeError(f"hybrid run: trainable moved {moved}/{len(trainable)}, frozen "
                           f"changed {changed[:5]}")
    return launches, steps, means, res


# (name, remat_unit or None for remat off, remat_policy)
REMAT_SETTINGS = (("off", None, ""), ('block ""', "block", ""), ("block dots", "block", "dots"),
                  ("block dots_no_batch", "block", "dots_no_batch"),
                  ("block dots_small", "block", "dots_small"), ('layer ""', "layer", ""))


def _training_remat(torch, np, res, wrappers):
    """(c) one step's gradients (no update) of the hybrid run's SD1.5 model on
    one posed batch for every remat setting: peak memory, s/step and launches
    per step; each setting's gradients against block "" (>= 60 dB). Captured
    and eager steps of four of these settings: phase train_graphs (e).
    -> {setting: (launches, steps)}."""
    import dataclasses

    from cvd_tpu_torch.train.train_step import loss_and_grads

    Fr, S = 16, 256
    state, modules = res["state"], res["modules"]
    unet = modules.unet
    base = unet.config
    batch = _folded(torch, np, _SeededPairs(1, Fr, S), Fr)
    grads, out, rows = {}, {}, []
    state.zero_grad()       # the run's last gradients: loss_and_grads adds to them
    try:
        for name, unit, policy in REMAT_SETTINGS:
            unet.config = dataclasses.replace(base, remat_unit=unit or "block",
                                              remat_policy=policy)
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            secs = []
            for _ in range(1):
                t0 = time.perf_counter()
                # the same draws every time: a fresh generator of one seed
                loss, _ = loss_and_grads(state, batch, modules,
                                         torch.Generator(device="cuda").manual_seed(0),
                                         F_mat_size=S, remat=unit is not None)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                # to the host one tensor at a time: no copy of the gradients
                # stays on the card into the next computation's peak
                grads[name] = np.concatenate([p.grad.float().cpu().numpy().ravel()
                                              for p in state.trainable_params()])
                state.zero_grad()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out[name] = ({n: w.launches for n, w in wrappers.items()}, len(secs))
            rows.append((name, peak, secs, float(loss)))
    finally:
        unet.config = base
    ref = grads['block ""']
    bad = []
    for name, peak, secs, loss in rows:
        snr = _snr_db(np, ref, grads[name])
        per_step = {n: c / out[name][1] for n, c in out[name][0].items()}
        log(f"[training] (c) remat {name}: peak allocated {peak:.2f} GiB, s/step "
            f"[{', '.join(f'{t:.3f}' for t in secs)}] (one computation, first-call costs "
            f"included), loss "
            f"{loss:.6f}, gradients vs block \"\" SNR {snr:.1f} dB, launches per step "
            f"{per_step}")
        if not snr >= 60.0:
            bad.append((name, snr))
    if bad:
        raise RuntimeError(f"remat settings whose gradients differ from block \"\": {bad}")
    return out


def _training_multihost(torch):
    """(d) two steps of ``run(..., multihost=True)`` as a world of one over
    NCCL at (b)'s size (SD1.5 width, every tensor drawn, bf16 frozen, 256 px,
    16 frames, remat on) against the same run without it, eager as the run
    under a process group is (``capture=False``): the losses bit for bit; the
    peak memory of each run; the multihost run's steps not captured.
    -> (launches of the multihost run, steps)."""
    import torch.distributed as dist

    from cvd_tpu_torch.cli import train

    Fr, S, steps = 16, 256, 2
    cfg = dict(random_weights_full=True, bf16=True, sample_size=S, sample_n_frames=Fr,
               train_batch_size=1, max_train_steps=steps, num_workers=2, remat=True,
               do_sanity_check=False, logger_interval=1, checkpointing_steps=10 ** 9,
               global_seed=42)

    def run(name, **kw):
        """-> (losses, kinds, rank, world size, step seconds, peak GiB, captured)"""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = train.run(dict(cfg, output_dir=os.path.join(HERE, "build", name)),
                        sources=[("posed", _SeededPairs(2, Fr, S), 0.5),
                                 ("unposed", _SeededFrames(2, Fr, S), 0.5)], **kw)
        torch.cuda.synchronize()
        out = (res["losses"], res["kinds"], res["rank"], res["world_size"],
               res["step_seconds"], torch.cuda.max_memory_allocated() / 2 ** 30,
               res["program"]["captured"])
        del res
        torch.cuda.empty_cache()
        return out

    wrappers = _wrappers()
    plain = run("chip_smoke_plain", capture=False)
    for w in wrappers.values():
        w.launches = 0
    with _TorchrunEnv():
        multi = run("chip_smoke_multi", multihost=True)
    launches = {n: w.launches for n, w in wrappers.items()}
    log(f"[training] (d) --multihost as a world of one over NCCL (rank {multi[2]} of "
        f"{multi[3]}), SD1.5 width, bf16 frozen, {S} px, {Fr} frames, remat on: losses "
        f"{multi[0]} ({multi[1]}) against {plain[0]} without it; s/step "
        f"[{', '.join(f'{t:.3f}' for t in multi[4])}] against "
        f"[{', '.join(f'{t:.3f}' for t in plain[4])}]; peak allocated {multi[5]:.2f} GiB "
        f"against {plain[5]:.2f} GiB; process group destroyed: {not dist.is_initialized()}; "
        f"steps captured: {multi[6]}")
    if (multi[0] != plain[0] or multi[3] != 1 or dist.is_initialized()
            or len(multi[0]) != steps or multi[6]):
        raise RuntimeError(f"multihost world of one: {multi[0]} vs {plain[0]}")
    return launches, steps


def phase_training(torch):
    """Unposed and hybrid training, the remat settings and --multihost (the
    module docstring, 11). -> {path: (launches, steps)}."""
    import numpy as np

    wrappers = _wrappers()
    t0 = time.perf_counter()
    _training_reference(torch, np)
    log(f"[time] training (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, steps, per_kind, res = _training_hybrid(torch, np, wrappers)
    log(f"[time] training (b): {time.perf_counter() - t0:.1f} s")
    out = {"hybrid": (launches, steps)}
    out.update({f"hybrid_{kind}": (counts, 1) for kind, counts in per_kind.items()})
    t0 = time.perf_counter()
    out.update({"remat_" + name.replace('""', "").strip().replace(" ", "_"): n
                for name, n in _training_remat(torch, np, res, wrappers).items()})
    log(f"[time] training (c): {time.perf_counter() - t0:.1f} s")
    del res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["multihost"] = _training_multihost(torch)
    log(f"[time] training (d): {time.perf_counter() - t0:.1f} s")
    return out


def _train_batches(torch, np, kind, n, Fr, S, vae=None):
    """``n`` host batches of ``kind`` as the training loop folds them
    (2 videos x ``Fr`` frames, ``S`` px, hash-tokenized captions): "posed"
    (phase 7's seeded pairs, pixels), "unposed" (seeded frames made into
    pseudo-pairs: pixels, H mats, warped masks) or "cache" (the posed
    pairs' posterior moments, encoded once by ``vae``, as the latents
    cache holds them)."""
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    tok = HashTokenizer()
    data = _SeededFrames(n, Fr, S) if kind == "unposed" else _SeededPairs(n, Fr, S)

    def fold(x):
        return torch.from_numpy(np.ascontiguousarray(np.concatenate([x[None, :Fr],
                                                                     x[None, Fr:]])))

    out = []
    for i in range(n):
        s = data[i]
        b = {"text_ids": torch.from_numpy(tok([s["text"]] * 2))}
        if kind == "unposed":
            b.update({k: fold(s[k]) for k in ("pixel_values", "H_mats", "warped_masks")})
        else:
            b.update(plucker=fold(s["plucker_embedding"]), F_mats=fold(s["F_mats"]))
            if kind == "posed":
                b["pixel_values"] = fold(s["pixel_values"])
            else:
                dtype = vae.quant_conv.weight.dtype
                with torch.no_grad():
                    mean, logvar = vae.encode(torch.from_numpy(s["pixel_values"])
                                              .to("cuda", dtype))
                b.update(latent_mean=fold(mean.float().cpu().numpy()),
                         latent_logvar=fold(logvar.float().cpu().numpy()))
        out.append(b)
    return out


VALIDATION = dict(sample_n_frames=16, sample_size=256, validation_steps_num=2,
                  validation_data=dict(
                      pose_file_0=os.path.join(HERE, "assets", "pose_files", "example_dolly.txt"),
                      pose_file_1=os.path.join(HERE, "assets", "pose_files", "example_arc.txt"),
                      prompts=["a scenic video"]))


def _max_diff(torch, a, b):
    """max |a - b| over the trainable weights of two states."""
    with torch.no_grad():
        return float(torch.stack([(x - y).abs().max() for x, y in
                                  zip(a.trainable_params(), b.trainable_params())]).max())


def _tg_step(torch, prog, batch, gen):
    """One step of a program, timed and counted -> its record."""
    before = dict(prog.stats["launches"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = prog.step(batch, gen)
    torch.cuda.synchronize()
    return dict(out, s=time.perf_counter() - t0,
                peak=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                peak_abs=torch.cuda.max_memory_allocated() / 2 ** 30,
                reserved=torch.cuda.max_memory_reserved() / 2 ** 30,
                launches={n: c - before[n] for n, c in prog.stats["launches"].items()})


def _tg_programs(torch, runs, unit, policy, S):
    """A program per run (eager, eager, captured, by name) at one remat
    setting; the runs' states go on from where they are."""
    import dataclasses

    from cvd_tpu_torch.train.program import TrainProgram

    torch.cuda.empty_cache()        # the last setting's graphs are gone
    progs = []
    for name, m, state, base in runs:
        m.unet.config = dataclasses.replace(base, remat_unit=unit or "block",
                                            remat_policy=policy)
        progs.append(TrainProgram(state, m, capture=name == "captured", F_mat_size=S,
                                  remat=unit is not None))
    return progs


def _tg_lockstep(torch, np, runs, progs, gens, kind, batches, setting, tok, vdir):
    """(a)-(d) for one kind at one remat setting: the three runs step in
    lockstep on the same batches; after every step the captured run's loss,
    grad norm and trainable weights differ from the first eager run's by no
    more than the second eager run's do. -> per-step records by run."""
    import logging

    from cvd_tpu_torch.cli import train
    from cvd_tpu_torch.train.checkpoint import restore, save

    name = setting[0]
    (_, ma, sa, _), (_, mb, sb, _), (_, mc, sc, _) = runs
    recs = [[], [], []]
    bad = []

    def compare(i, got, what, weights=True):
        want, spread = recs[0][i], recs[1][i]
        dq = {q: (abs(spread[q] - want[q]), abs(got[q] - want[q])) for q in ("loss", "grad_norm")}
        if weights:
            dq["weights"] = (_max_diff(torch, sb, sa), _max_diff(torch, sc, sa))
        log(f"[train_graphs] {what} {kind}, remat {name}, step {i + 1}: loss eager "
            f"{want['loss']:.7f} / {spread['loss']:.7f}, captured {got['loss']:.7f}; "
            + "; ".join(f"{q} |eager2 - eager| {a:.3g}, |captured - eager| {b:.3g}"
                        for q, (a, b) in dq.items()))
        over = {q: d for q, d in dq.items() if d[1] > d[0]}
        if over:
            bad.append((what, kind, name, i + 1, over))

    resume = kind == "posed" and setting[1] is None
    path = os.path.join(vdir, "step-2.pt")
    captures = progs[2].stats["captures"]
    for i, batch in enumerate(batches):
        for r, (prog, gen) in enumerate(zip(progs, gens)):
            recs[r].append(_tg_step(torch, prog, batch, gen))
        compare(i, recs[2][i], "(a)")
        if resume and i == 1:
            save(path, sc, epoch=0)
            at_two = gens[2].get_state()
        if resume and i in (1, 3):     # (c) validation after captured steps
            videos = []
            for r, m in enumerate((ma, mb, mc)):
                out_dir = os.path.join(vdir, f"run{r}")
                train.run_validation(m, tok, VALIDATION, out_dir, i + 1,
                                     logging.getLogger("chip_smoke"))
                videos.append(np.load(os.path.join(out_dir, "validation",
                                                   f"step-{i + 1}.npy")).astype(np.int16))
            spread = int(np.abs(videos[1] - videos[0]).max())
            diff = int(np.abs(videos[2] - videos[0]).max())
            log(f"[train_graphs] (c) validation at step {i + 1} after {kind} steps, remat "
                f"{name}: videos {videos[0].shape} uint8, max |eager2 - eager| {spread}, "
                f"max |captured - eager| {diff}")
            if diff > spread:
                bad.append(("(c)", kind, name, i + 1, {"videos": (spread, diff)}))
    launches = [{n: sum(r["launches"][n] for r in rec) for n in KERNELS} for rec in recs]
    log(f"[train_graphs] (b) {kind}, remat {name}: K1-K7 launches over {len(batches)} steps "
        f"equal, eager and captured: {launches[2] == launches[0] == launches[1]} "
        f"({launches[2]}); graphs captured {progs[2].stats['captures'] - captures}")
    if not launches[2] == launches[0] == launches[1]:
        bad.append(("(b)", kind, name, 0, {"launches": (launches[0], launches[2])}))
    if resume:      # (d) restore at step 2, then captured steps 3 and 4 again
        captures = progs[2].stats["captures"]
        restore(path, sc)
        gens[2].set_state(at_two)
        for j, b in enumerate(batches[2:]):
            # the weights after step 3 again: only step 4's are comparable
            compare(2 + j, _tg_step(torch, progs[2], b, gens[2]), "(d) resumed", weights=j == 1)
        log(f"[train_graphs] (d) save at step 2, restore, steps 3-4 replayed again: graphs "
            f"captured {progs[2].stats['captures'] - captures}")
        if progs[2].stats["captures"] != captures:
            bad.append(("(d)", kind, name, 0, {"captures": (captures, progs[2].stats["captures"])}))
    if bad:
        raise RuntimeError(f"captured training differs from eager beyond eager's spread: {bad}")
    return recs


def _tg_timing(torch, runs, kinds, settings, S):
    """(e) captured and eager steps in turns (eager, captured, captured,
    eager, after one captured step that captures) per kind and remat
    setting (``settings``: (name, remat_unit, remat_policy, kinds)); the
    graph pool's size from the reserved memory around that capture ->
    {(setting, kind): (rows, first step, capture s, pool GiB)}."""
    out = {}
    gens = [torch.Generator(device="cuda").manual_seed(12) for _ in runs]
    for name, unit, policy, names in settings:
        pe, pc = _tg_programs(torch, runs, unit, policy, S)
        for kind in names:
            batches = kinds[kind]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            stats = dict(pc.stats)
            first = _tg_step(torch, pc, batches[0], gens[1])
            pool = (torch.cuda.memory_reserved() - before) / 2 ** 30
            rows = {"eager": [], "captured": []}
            for mode, b in zip(("eager", "captured", "captured", "eager"), batches):
                prog, gen = (pc, gens[1]) if mode == "captured" else (pe, gens[0])
                rows[mode].append(_tg_step(torch, prog, b, gen))
            out[(name, kind)] = (rows, first, pc.stats["capture_s"] - stats["capture_s"], pool)
        del pe, pc
    return out


def _tg_report_timing(timing, lockstep):
    """The [train_graphs] (e) lines: s/step captured vs eager per setting."""
    for (name, kind), (rows, first, capture_s, pool) in timing.items():
        log(f"[train_graphs] (e) {kind}, remat {name}, in turns: eager s/step "
            f"[{', '.join(f'{r['s']:.3f}' for r in rows['eager'])}], captured "
            f"[{', '.join(f'{r['s']:.3f}' for r in rows['captured'])}]; first captured step "
            f"{first['s']:.3f} s (eager, then the capture: {capture_s:.2f} s); an eager step's "
            f"peak allocated above what was resident "
            f"{max(r['peak'] for r in rows['eager']):.2f} GiB (absolute "
            f"{max(r['peak_abs'] for r in rows['eager']):.2f}), the graph's pool "
            f"{pool:.2f} GiB (reserved; a replay allocates nothing); peak reserved eager "
            f"{max(r['reserved'] for r in rows['eager']):.2f} GiB (pool included)")
    for (name, kind), recs in lockstep.items():
        e1, e2, c = ([r["s"] for r in rec] for rec in recs)
        log(f"[train_graphs] (e) {kind}, remat {name}, lockstep of (a) (eager, eager, captured "
            f"each step): eager s/step [{', '.join(f'{x:.3f}' for x in e1)}] / "
            f"[{', '.join(f'{x:.3f}' for x in e2)}], captured "
            f"[{', '.join(f'{x:.3f}' for x in c)}]; an eager step's peak allocated above "
            f"resident {max(r['peak'] for r in recs[0]):.2f} GiB")


def _tg_profile(torch, progs, gens, batches):
    """(f) torch.profiler over one captured and one eager step (the programs
    of (a)'s last setting, remat on), after their warm-ups: the idle share
    of each."""
    from cvd_tpu_torch.utils.profiling import trace

    idle = {}
    for mode, prog, gen in (("eager", progs[0], gens[0]), ("captured", progs[2], gens[2])):
        torch.cuda.synchronize()
        with trace(_profile_dir(f"train_step_{mode}")) as prof:
            t0 = time.perf_counter()
            prog.step(batches[0], gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        idle[mode] = _report_profile(prof, wall, 1, f"one remat-on (block \"\") posed training "
                                     f"step, {mode}", f"train_step_{mode}_profile.txt")
    log(f"[train_graphs] (f) idle share of a remat-on posed step: captured "
        f"{idle['captured']['idle_share']:.1%} ({idle['captured']['device_ms']:.1f} ms of "
        f"kernels), eager {idle['eager']['idle_share']:.1%} "
        f"({idle['eager']['device_ms']:.1f} ms; its AdamW.step range is counted as device "
        f"time by the profiler)")


def _tg_full_width(torch, np):
    """(g) two f32 steps of the SD1.5-wide model (every tensor drawn, f32
    frozen, TF32 off), 2 videos x 4 frames at 64 px, remat off, through the
    program on the card (the first runs eagerly before the capture, the
    second is replayed) against the same steps on the CPU from the same
    weights, batch and pinned draws: the replayed step's loss to 1e-5
    relative, its clipped gradients and the updated weights at >= 60 dB."""
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.models.vae import VAEConfig
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.program import TrainProgram
    from cvd_tpu_torch.train.state import create_train_state

    Fr, S = 4, 64
    batch = _train_batches(torch, np, "posed", 1, Fr, S)[0]
    rng = np.random.default_rng(12)
    batch.update(latents=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4))
                                          .astype(np.float32)),
                 noise=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4))
                                        .astype(np.float32)),
                 timesteps=torch.from_numpy(np.array([271, 804])),
                 slope=torch.from_numpy(np.array([1.1], np.float32)))
    del batch["pixel_values"]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        # drawn on the card (fast), then loaded into an uninitialized CPU bundle
        gpu = PipelineModules.create(UNetConfig(), VAEConfig(), CLIPTextConfig(), device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(13),
                                     random_full=True)
        cpu = PipelineModules.create(UNetConfig(), VAEConfig(), CLIPTextConfig(), device="cpu")
        for name in ("unet", "clip", "pose_encoder"):
            getattr(cpu, name).load_state_dict(getattr(gpu, name).state_dict())
        built = time.perf_counter() - t0
        results = []
        for m in (cpu, gpu):
            state = create_train_state(m.unet, learning_rate=1e-4)
            prog = TrainProgram(state, m, F_mat_size=S, remat=False)
            gen = torch.Generator(device=m.unet.conv_in.weight.device).manual_seed(0)
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                out = prog.step(batch, gen)
                secs.append(time.perf_counter() - t0)
            params = state.trainable_params()
            results.append((out, np.concatenate([p.grad.cpu().numpy().ravel() for p in params]),
                            np.concatenate([p.detach().cpu().numpy().ravel() for p in params]),
                            secs, prog.stats["captures"] == 1 and prog.stats["captured"]))
            del state, prog
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (want, g_ref, w_ref, cpu_s, _), (got, g, w, gpu_s, captured) = results
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    snr_g, snr_w = _snr_db(np, g_ref, g), _snr_db(np, w_ref, w)
    log(f"[train_graphs] (g) SD1.5-wide steps f32 (TF32 off), 2 x {Fr} frames at {S} px, remat "
        f"off, the second {'replayed' if captured else 'EAGER'} on the card vs the CPU: loss "
        f"{got['loss']:.7f} / {want['loss']:.7f} (rel {rel:.1e}), grad norm "
        f"{got['grad_norm']:.6f} / {want['grad_norm']:.6f}; clipped gradients ({g.size} values) "
        f"SNR {snr_g:.1f} dB, updated weights {snr_w:.1f} dB; card steps "
        f"{gpu_s[0]:.2f} s (eager, capture included) / {gpu_s[1]:.2f} s (replayed), CPU "
        f"{cpu_s[0]:.2f} / {cpu_s[1]:.2f} s, build {built:.1f} s")
    del cpu, gpu
    torch.cuda.empty_cache()
    if not (captured and rel <= 1e-5 and snr_g >= 60.0 and snr_w >= 60.0):
        raise RuntimeError(f"full-width step card vs CPU: captured {captured}, loss rel "
                           f"{rel:.1e}, gradients {snr_g:.1f} dB, weights {snr_w:.1f} dB")


def phase_train_graphs(torch, profile: bool):
    """The training step replayed as CUDA graphs against eager steps (the
    module docstring, train_graphs). -> (launches, steps) of the captured
    run of (a)."""
    import random

    import numpy as np

    from cvd_tpu_torch.cli import train
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.train.state import create_train_state

    Fr, S, steps = 16, 256, 4
    vdir = os.path.join(HERE, "build", "chip_smoke_train_graphs")
    os.makedirs(vdir, exist_ok=True)
    t0 = time.perf_counter()
    runs = []
    for name in ("eager", "eager2", "captured"):
        m, _ = train.build_training_modules(dict(random_weights_full=True, bf16=True),
                                            torch.device("cuda"))
        state = create_train_state(m.unet, learning_rate=1e-4, scheduler="cosine",
                                   warmup_steps=0, total_steps=40, frozen_dtype=torch.bfloat16)
        runs.append((name, m, state, m.unet.config))
    posed = _train_batches(torch, np, "posed", steps, Fr, S)
    unposed = _train_batches(torch, np, "unposed", steps, Fr, S)
    cache = _train_batches(torch, np, "cache", steps, Fr, S, vae=runs[0][1].vae)
    draw = random.Random(43)        # hybrid, posed_ratio 0.5
    hybrid = [posed[i] if draw.random() < 0.5 else unposed[i] for i in range(steps)]
    log(f"[train_graphs] three bundles at SD1.5 width (bf16 frozen, f32 masters, "
        f"{sum(p.numel() for p in runs[0][2].trainable_params())} trainable values) and the "
        f"batches in {time.perf_counter() - t0:.1f} s; hybrid kinds "
        f"{['posed' if 'plucker' in b else 'unposed' for b in hybrid]}")
    tok = HashTokenizer()
    gens = [torch.Generator(device="cuda").manual_seed(11) for _ in runs]
    lockstep, launches, n_steps = {}, {n: 0 for n in KERNELS}, 0
    # the runs go on from kind to kind and setting to setting: 32 steps each
    for setting in (("off", None, ""), ('block ""', "block", "")):
        progs = _tg_programs(torch, runs, setting[1], setting[2], S)
        for kind, batches in (("posed", posed), ("unposed", unposed), ("hybrid", hybrid),
                              ("cache", cache)):
            t1 = time.perf_counter()
            recs = _tg_lockstep(torch, np, runs, progs, gens, kind, batches, setting, tok, vdir)
            lockstep[(setting[0], kind)] = recs
            for r in recs[2]:
                for n in KERNELS:
                    launches[n] += r["launches"][n]
            n_steps += len(recs[2])
            log(f"[time] train_graphs (a) {kind} remat {setting[0]}: "
                f"{time.perf_counter() - t1:.1f} s")
        log(f"[train_graphs] (a) remat {setting[0]}: {progs[2].stats['captures']} graphs captured "
            f"in {progs[2].stats['capture_s']:.2f} s")
    if profile:
        _tg_profile(torch, progs, gens, posed)
    del progs
    del runs[1]         # (e): the first eager run and the captured one
    t1 = time.perf_counter()
    both = ("posed", "unposed")
    timing = _tg_timing(torch, runs, {"posed": posed, "unposed": unposed},
                        (('layer ""', "layer", "", both), ("block dots", "block", "dots", both),
                         ("block dots_no_batch", "block", "dots_no_batch", ("posed",)),
                         ("block dots_small", "block", "dots_small", ("posed",))), S)
    _tg_report_timing(timing, {k: v for k, v in lockstep.items()
                               if k[1] in ("posed", "unposed")})
    log(f"[time] train_graphs (e): {time.perf_counter() - t1:.1f} s")
    for _, m, _, base in runs:
        m.unet.config = base
    del runs, posed, unposed, cache, hybrid
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _tg_full_width(torch, np)
    log(f"[time] train_graphs (g): {time.perf_counter() - t1:.1f} s")
    return launches, n_steps


def _folded(torch, np, data, n_frames):
    """The training loop's folded device batch for item 0 (text unchanged)."""
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    s = data[0]

    def fold(x):
        return torch.from_numpy(np.concatenate([x[None, :n_frames], x[None, n_frames:]]))

    return {"text_ids": torch.from_numpy(HashTokenizer()([s["text"]] * 2)),
            "pixel_values": fold(s["pixel_values"]), "plucker": fold(s["plucker_embedding"]),
            "F_mats": fold(s["F_mats"])}


def _profile_dir(name):
    """Where ``utils.profiling.trace`` writes a profiled window's Chrome
    trace: under build/ (git-ignored; too large to bring back)."""
    return os.path.join(HERE, "build", "profiles", name)


def _report_profile(prof, wall, steps, what, path):
    """Device time by kernel of a profiled window of ``steps`` steps
    (``utils.profiling.kernel_summary``): the sums per step on the log, the
    whole table in chiprun_out/."""
    from cvd_tpu_torch.utils.profiling import kernel_summary

    summary = kernel_summary(prof, wall, steps, what, PORT_KERNELS)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, path), "w") as f:
        f.write(f"{what}: {steps} step(s), wall {wall * 1e3:.1f} ms, kernel time "
                f"{summary['device_ms'] * steps:.1f} ms\n{summary['table']}\n")
    for line in summary["lines"]:
        log(f"[profile] {line}")
    return summary


def _profile_sampler(torch):
    """torch.profiler over three bf16 UNet steps of the sampler at SD1.5
    width (4 CFG rows x 16 frames, 256 px, no decode), after a warm-up run."""
    import numpy as np

    from cvd_tpu_torch.models.clip_text import CLIPTextConfig
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.models.vae import VAEConfig
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.simple import SimplePipeline
    from cvd_tpu_torch.utils.profiling import trace

    modules = PipelineModules.create(UNetConfig(), VAEConfig(), CLIPTextConfig(), device="cuda",
                                     dtype=torch.bfloat16, random_full=True,
                                     generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    Fr, S, steps = 16, 256, 3
    inputs = dict(
        prompt_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        negative_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        plucker=torch.from_numpy(rng.standard_normal((2, Fr, S, S, 6)).astype(np.float32)),
        F_mats=torch.from_numpy((rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)),
        latents=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4)).astype(np.float32)),
    )
    inputs["generator"] = torch.Generator(device="cuda").manual_seed(0)  # the epi slope
    for capture in (False, True):
        mode = "captured" if capture else "eager"
        pipe = SimplePipeline(modules, capture=capture)
        pipe(**inputs, num_inference_steps=steps, decode=False)
        torch.cuda.synchronize()
        with trace(_profile_dir(f"sampler_step_{mode}")) as prof:
            t0 = time.perf_counter()
            pipe(**inputs, num_inference_steps=steps, decode=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report_profile(prof, wall, steps, f"sampler, bf16 UNet steps, {mode} (text and pose "
                        "encoders included once)", f"sampler_step_{mode}_profile.txt")
    del modules, pipe
    torch.cuda.empty_cache()


def _net_of_warmups(launches, records):
    """A sampler run's launches without those of its warm-ups."""
    return {n: launches[n] - sum(r["program"]["warmup_launches"][n] for r in records)
            for n in launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if "--mesh-worker" in sys.argv[1:]:
        return mesh_worker()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "cvd_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_all = time.perf_counter()
    profile = "--profile" in sys.argv[1:]

    def timed(phase, *args, **kw):
        t0 = time.perf_counter()
        out = phase(torch, *args, **kw)
        log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    smi = phase_device(torch)
    t_nvcc, t_build = phase_build(torch)
    if "--mesh" in sys.argv[1:]:
        timed(mesh_cards)
        log(f"[total] {time.perf_counter() - t_all:.1f} s; the four-card run (--mesh): no result")
        log(smi)
        return 5
    if "--ckpt" in sys.argv[1:]:
        timed(phase_reference)
        sampler, _, unet_ms, _, records = timed(phase_slice)
        timed(phase_ckpt, _net_of_warmups(sampler, records), sampler_requests=2,
              unet_ms=unet_ms, smi=smi)
        log(f"[total] {time.perf_counter() - t_all:.1f} s; a partial run (--ckpt): no result")
        log(smi)
        return 4
    report = timed(phase_kernels)
    timed(phase_reference)
    timed(phase_train_reference)
    sampler, unet_steps, unet_ms, sampler_videos, slice_records = timed(phase_slice)
    nview, nview_videos, nview_records = timed(phase_nview)
    graphs, graphs_per_call, _ = timed(phase_graphs, sampler_videos, slice_records,
                                       nview_videos, nview_records)
    mesh_report, mesh = timed(phase_mesh, sampler_videos, nview_videos)
    del sampler_videos, nview_videos
    if profile:
        timed(_profile_sampler)
        timed(_profile_nview)
    train, train_steps, train_seconds = timed(phase_train)
    ((ckpt_sampler, ckpt_steps), (ckpt_train, ckpt_train_steps)), options = timed(
        phase_ckpt, _net_of_warmups(sampler, slice_records), sampler_requests=2,
        train_seconds=train_seconds, unet_ms=unet_ms, smi=smi)
    training = timed(phase_training)
    train_graphs = timed(phase_train_graphs, profile=profile)
    # the training phase's entry-point runs count toward "launches"; its
    # per-kind means and the remat settings' loss_and_grads runs stand beside
    runs = {path: training[path] for path in ("hybrid", "multihost")}
    runs["train_graphs"] = train_graphs
    runs.update({f"mesh_{path}": n for path, n in mesh.items()})
    runs.update({f"graphs_{path}": n for path, n in graphs.items()})
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = report[name]
        # phase mesh (a): the errors at the sharded shapes count into the kernel's
        for key in ("max_abs_err", "max_abs_err_f32", "err_over_limit", "err_over_limit_f32"):
            r[key] = max(r[key], mesh_report[name][key])
        # launches: the sum over the main paths driven above, each with the
        # counts set to 0 just before it and read just after (2-view sampler,
        # N-view sampler as a loop and batched, training, and the sampler and
        # training built from checkpoint files); each path's own count is
        # beside it. Per step or call: a run's count over the UNet
        # calls or steps it took (a sampler's K4 count includes its VAE decode)
        # phases options and extras: each of their paths, and per UNet call,
        # SparseCtrl call or training step
        (nview_loop, loop_calls), (nview_batched, batched_calls) = nview["loop"], nview["batched"]
        opts = {f"launches_{path}": n[name] for path, (n, _) in options.items()}
        opts.update({f"launches_per_call_{path}": n[name] / calls
                     for path, (n, calls) in options.items()})
        sampling = ("mesh_", "graphs_")
        opts.update({f"launches_training_{path}": n[name] for path, (n, _) in runs.items()
                     if not path.startswith(sampling)})
        opts.update({f"launches_{path}": n[name] for path, (n, _) in runs.items()
                     if path.startswith(sampling)})
        opts.update({f"launches_per_call_{path}": n[name] / calls
                     for path, (n, calls) in runs.items() if path.startswith(sampling)})
        # phase graphs (e): the denoising loop's launches per UNet call, captured / eager
        opts.update({f"launches_per_loop_call_{path}_{mode}": per[i].get(name)
                     for path, per in graphs_per_call.items()
                     for i, mode in enumerate(("captured", "eager"))})
        if mesh_report[name].get("timings"):
            opts["mesh_timings"] = mesh_report[name]["timings"]
        opts.update({f"launches_per_training_{path}_step": n[name] / steps
                     for path, (n, steps) in training.items() if path not in runs})
        # phase train_graphs: the captured runs' launches per replayed step
        opts["launches_per_train_graphs_step"] = train_graphs[0][name] / train_graphs[1]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": (sampler[name] + nview_loop[name] + nview_batched[name]
                                     + train[name] + ckpt_sampler[name] + ckpt_train[name]
                                     + sum(n[name] for n, _ in options.values())
                                     + sum(n[name] for n, _ in runs.values())),
                        **opts,
                        "launches_ckpt_sampler": ckpt_sampler[name],
                        "launches_ckpt_train": ckpt_train[name],
                        "launches_per_ckpt_unet_step": ckpt_sampler[name] / ckpt_steps,
                        "launches_per_ckpt_train_step": ckpt_train[name] / ckpt_train_steps,
                        "launches_sampler": sampler[name], "launches_nview": nview_loop[name],
                        "launches_nview_batched": nview_batched[name],
                        "launches_train": train[name],
                        "launches_per_unet_step": sampler[name] / unet_steps,
                        "launches_per_nview_call": nview_loop[name] / loop_calls,
                        "launches_per_nview_batched_call": nview_batched[name] / batched_calls,
                        "launches_per_train_step": train[name] / train_steps,
                        "max_abs_err": r["max_abs_err"],
                        "max_abs_err_f32": r["max_abs_err_f32"],
                        "err_over_limit": r["err_over_limit"],
                        "err_over_limit_f32": r["err_over_limit_f32"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "library_call": r["library_call"], "wrapper_ms": r["wrapper_ms"],
                        "timed_shape": r["timed_shape"], "timings": r["timings"]})
    log(f"[total] {time.perf_counter() - t_all:.1f} s (building the kernels {t_build:.1f} s, "
        f"nvcc {t_nvcc:.1f} s of it)")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

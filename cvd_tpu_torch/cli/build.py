"""Pipeline assembly for the CLIs — the get_pipeline equivalent
(inference_epi.py:72-145; port of ``cvd_tpu/cli/build.py``): build the
modules and load the four checkpoint kinds, or build a random-weight
bundle when asked to.

    python -m cvd_tpu_torch.cli.build --validate-ckpts [--ori_model_path DIR ...]

``--random-weights`` builds the tiny model from the default initialization
(epi modules start as the identity), ``--random-weights-full`` the SD1.5
widths with every tensor drawn. The runtime image LoRA
(``--image_lora_ckpt``), the sync-LoRA (``--sync_lora_rank``), spatial
extended attention and SparseCtrl (``--controlnet_ckpt``, built beside the
UNet as ``modules.controlnet``; no pipeline consumes it, as in the JAX
package) are the JAX package's options. ``--civitai_base_model`` (an SD1.x
single-file LDM checkpoint: ``.ckpt``, or ``.safetensors`` with the
``safetensors`` package) replaces the SD folder's UNet, VAE and text-encoder
weights, and ``--civitai_lora_ckpt`` (a kohya LoRA) is fused into the UNet
at 0.6 (``io/ldm_convert.py``), after the other files, in the JAX package's
order. ``--scan_layers`` is taken and does nothing (an XLA compile-time
layer dedup). ``--model_config`` sets the modules' layout, for files and
random weights alike; one with a ``backbone`` section (CVD on the SDXL
backbone: ``configs/sdxl_inference_config.yaml``) also gives every width,
the motion and epi modules' heads, the second text encoder (its diffusers
folder's ``text_encoder_2/``) and the VAE's scale.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Tuple

import torch
from torch import nn

from cvd_tpu_torch.io.tokenizer import get_tokenizer
from cvd_tpu_torch.models.clip_text import CLIPTextConfig
from cvd_tpu_torch.models.unet import UNetConfig
from cvd_tpu_torch.models.vae import VAEConfig
from cvd_tpu_torch.pipelines.common import PipelineModules

SMOKE_UNET = UNetConfig(
    block_out_channels=(32, 64, 64, 64),
    attention_heads=4,
    cross_attention_dim=24,
    norm_num_groups=8,
)
SMOKE_VAE = VAEConfig(block_out_channels=(32, 32, 64, 64), norm_num_groups=8)
SMOKE_CLIP = CLIPTextConfig(hidden_size=24, num_layers=2, num_heads=4, intermediate_size=48)
SMOKE_WIDTHS = (SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP)
# what a build from checkpoint files is as wide as unless the caller says
# otherwise: the released artifacts are all SD1.5's
SD15_WIDTHS = (UNetConfig(), VAEConfig(), CLIPTextConfig())
# the options that name weights: --random-weights[-full] refuses them
_WEIGHT_OPTIONS = ("ori_model_path", "motion_module_ckpt", "motion_lora_ckpt",
                   "epi_module_ckpt", "pose_adaptor_ckpt", "image_lora_ckpt", "controlnet_ckpt",
                   "civitai_base_model", "civitai_lora_ckpt")


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ori_model_path", default=None, help="SD1.5 diffusers folder")
    p.add_argument("--unet_subfolder", default="unet", help="e.g. unet_webvidlora_v3")
    p.add_argument("--motion_module_ckpt", default=None)
    p.add_argument("--motion_lora_ckpt", default=None,
                   help="AnimateDiff motion-LoRA ckpt (pan/zoom effects), "
                        "fused into the temporal attentions at load")
    p.add_argument("--motion_lora_scale", type=float, default=1.0)
    p.add_argument("--epi_module_ckpt", default=None)
    p.add_argument("--pose_adaptor_ckpt", default=None)
    p.add_argument("--image_lora_ckpt", default=None,
                   help="runtime image LoRA (CameraCtrl's RealEstate10K LoRA), kept "
                        "unfused on the spatial attentions")
    p.add_argument("--civitai_lora_ckpt", default=None,
                   help="kohya / civitai LoRA (lora_unet_* / lora_te_* pairs), fused into "
                        "the UNet's weights at alpha 0.6 after every other file")
    p.add_argument("--civitai_base_model", default=None,
                   help="civitai / LDM single-file SD1.x model (.ckpt; .safetensors needs "
                        "the safetensors package): its UNet, VAE and text encoder replace "
                        "the SD folder's")
    p.add_argument("--random-weights", action="store_true", dest="random_weights",
                   help="tiny random-weight smoke mode (no checkpoints needed)")
    p.add_argument("--random-weights-full", action="store_true",
                   dest="random_weights_full",
                   help="FULL-SIZE random weights (SD1.5 widths, drawn on the "
                        "device from a fixed seed): real deployment shapes "
                        "without checkpoints, garbage pixels")
    p.add_argument("--pose_adaptor_scale", type=float, default=1.0)
    p.add_argument("--bf16", action="store_true", help="bfloat16 weights and activations")
    p.add_argument("--spatial_extended_attention", action="store_true",
                   help="spatial self-attention sees both videos of the pair")
    p.add_argument("--image_lora_rank", type=int, default=2,
                   help="rank of --image_lora_ckpt: > 16 absolute, else channels // rank "
                        "per layer")
    p.add_argument("--controlnet_ckpt", default=None,
                   help="AnimateDiff SparseCtrl ckpt; imported strictly into a "
                        "SparseControlNetModel (modules.controlnet) whose residuals the "
                        "UNet takes (down/mid additional residuals)")
    p.add_argument("--controlnet_simplified_embedding", action="store_true",
                   help="v3-RGB SparseCtrl layout: one zero-initialized conv over the "
                        "VAE latents and the mask as the conditioning embedding")
    p.add_argument("--sync_lora_rank", type=int, default=0,
                   help="sync-LoRA rank on the pose-conditioned temporal attention "
                        "(0 = off, >16 absolute, 1..16 resolves per layer)")
    p.add_argument("--sync_lora_scale", type=float, default=1.0)
    p.add_argument("--remat_policy", default="",
                   help="what a training remat unit saves: '' nothing (every op "
                        "replayed in the backward), 'dots' the matrix product and "
                        "convolution outputs, 'dots_no_batch' the 2-D products only, "
                        "'dots_small' those of 'dots' of at most "
                        "CVD_TPU_REMAT_SAVE_MAX_BYTES bytes (default 96 MiB); the three "
                        "'dots' values exist for the JAX package's configs: on an H100 "
                        "each took more memory than remat_unit 'layer' with '', and "
                        "more time only eagerly (PERF.md, section 5)")
    p.add_argument("--model_config", default=None,
                   help="reference-format model config yaml")
    p.add_argument("--scan_layers", action=argparse.BooleanOptionalAction, default=None,
                   help="taken and ignored: the JAX package's lax.scan dedup of identical "
                        "UNet layers is an XLA compile-time lever with no job here")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; a machine without a CUDA "
                        "device must ask for --device cpu)")


def resolve_device(requested: Optional[str]) -> torch.device:
    """The device an entry point runs on: the one asked for, else the card.
    Without a card nothing falls back to the CPU silently: a run there has
    to be asked for (``--device cpu`` / ``device: cpu``)."""
    if requested:
        return torch.device(requested)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: cvd_tpu_torch runs on the GPU by default; "
                           "pass --device cpu (config key `device: cpu`) to run on the CPU")
    return torch.device("cuda")


def unet_options(args, unet_cfg: UNetConfig) -> UNetConfig:
    """``unet_cfg`` with what the options set: the pose-adaptor scale, spatial
    extended attention, the sync-LoRA, the remat unit and policy (training's
    ``remat_unit`` / ``remat_policy``) and, with ``--image_lora_ckpt``, the
    image LoRA's rank (``r`` if > 16, else channels // r per layer,
    cvd_tpu/cli/build.py:158-163)."""
    r = getattr(args, "image_lora_rank", 2)
    return dataclasses.replace(
        unet_cfg, pose_scale=getattr(args, "pose_adaptor_scale", 1.0),
        spatial_extended_attention=bool(getattr(args, "spatial_extended_attention", False)),
        spatial_lora_rank=(r if r > 16 else -r) if getattr(args, "image_lora_ckpt", None) else 0,
        sync_lora_rank=getattr(args, "sync_lora_rank", 0) or 0,
        sync_lora_scale=getattr(args, "sync_lora_scale", 1.0),
        remat_unit=getattr(args, "remat_unit", "block"),
        remat_policy=getattr(args, "remat_policy", "") or "")


def load_sparse_controlnet(path: str, unet_cfg: UNetConfig, simplified: bool,
                           device: torch.device, dtype: torch.dtype) -> nn.Module:
    """A ``SparseControlNetModel`` at ``unet_cfg``'s widths in the layout of
    the file (``simplified``: v3 RGB, 4 latent channels; else the pyramid
    over 3 pixel channels), every parameter from the file (strict), on
    ``device`` in ``dtype``, in eval mode with no gradients."""
    from cvd_tpu_torch.io.checkpoints import load_sparse_controlnet_weights
    from cvd_tpu_torch.models.sparse_controlnet import SparseControlNetModel

    with torch.device("meta"):
        model = SparseControlNetModel(unet_cfg, conditioning_channels=4 if simplified else 3,
                                      use_simplified_condition_embedding=simplified)
    model = model.to_empty(device=device)
    load_sparse_controlnet_weights(model, path)
    model = model.to(dtype=dtype).eval().requires_grad_(False)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _model_config(path: str, unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                  clip_cfg: CLIPTextConfig) -> tuple:
    """-> (UNet, VAE, CLIP, second CLIP or None, pose-encoder kwargs,
    scheduler) of the model config at ``path``: the given widths, or its
    backbone's."""
    from cvd_tpu_torch.io.model_config import load_model_config

    unet_cfg, pose_encoder_kwargs, scheduler, extra = load_model_config(path, base=unet_cfg)
    backbone = extra["backbone"] or {"vae": vae_cfg, "clip": clip_cfg, "clip_2": None}
    return (unet_cfg, backbone["vae"], backbone["clip"], backbone["clip_2"],
            pose_encoder_kwargs, scheduler)


def build_modules(args, device: torch.device, vae_encoder: bool = False,
                  unet_dtype: Optional[torch.dtype] = None, tokenizer: Optional[object] = None,
                  report: Optional[dict] = None, widths=SD15_WIDTHS
                  ) -> Tuple[PipelineModules, object]:
    """-> (modules, tokenizer). With ``--random-weights[-full]`` a seeded
    random bundle at the smoke widths or SD1.5's, with what
    ``--model_config`` sets, and the hash tokenizer (a weight option beside
    it raises: it would be ignored); else the modules at ``widths`` (UNet,
    VAE and CLIP configs; SD1.5's, narrower only for narrow files) with what
    ``--model_config`` sets, initialized by ``default_init_``
    (so a module that no checkpoint is given for starts as the reference's
    fresh one: without ``--epi_module_ckpt`` the epi modules are the
    identity, a LoRA's ``up`` zero) and then filled from ``--ori_model_path``
    and the motion, epi, pose-adaptor, image-LoRA and SparseCtrl checkpoints,
    then the civitai base model and LoRA, with the SD folder's CLIP
    tokenizer.

    ``vae_encoder`` and ``unet_dtype`` are what training adds: the VAE's
    encoder, and the UNet held in f32 whatever ``--bf16`` says (a checkpoint's
    values then reach the f32 masters unrounded; ``create_train_state`` casts
    the frozen part after). ``tokenizer`` stands in for the one the SD folder
    or the random-weights mode would give (a machine without the CLIP
    vocabulary). ``report``: a dict that receives, per checkpoint artifact,
    the keys consumed and the seconds taken."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    random_full = getattr(args, "random_weights_full", False)
    random = args.random_weights or random_full
    generator = torch.Generator(device=device).manual_seed(0)
    if random:
        given = [name for name in _WEIGHT_OPTIONS if getattr(args, name, None)]
        if given:
            raise ValueError("--random-weights / --random-weights-full build from no file: "
                             "drop " + ", ".join(f"--{name}" for name in given))
        widths = SD15_WIDTHS if random_full else SMOKE_WIDTHS
    else:
        if not getattr(args, "ori_model_path", None):
            raise ValueError("no weights to build from: pass --ori_model_path (an SD1.5 "
                             "diffusers folder; config key `ori_model_path`) or "
                             "--random-weights / --random-weights-full (`random_weights` / "
                             "`random_weights_full`)")
        if getattr(args, "motion_lora_ckpt", None) and not args.motion_module_ckpt:
            raise ValueError("--motion_lora_ckpt fuses into the motion module: it needs "
                             "--motion_module_ckpt")
        # before the weights are read: a wrong folder fails in no time
        tokenizer = tokenizer or get_tokenizer(args.ori_model_path)

    unet_cfg, vae_cfg, clip_cfg = widths
    clip_2_cfg = pose_encoder_kwargs = scheduler = None
    if getattr(args, "model_config", None):
        unet_cfg, vae_cfg, clip_cfg, clip_2_cfg, pose_encoder_kwargs, scheduler = _model_config(
            args.model_config, unet_cfg, vae_cfg, clip_cfg)
    modules = PipelineModules.create(
        unet_config=unet_options(args, unet_cfg),
        vae_config=vae_cfg, clip_config=clip_cfg, clip_2_config=clip_2_cfg,
        pose_encoder_kwargs=pose_encoder_kwargs, scheduler=scheduler,
        device=device, dtype=dtype, unet_dtype=unet_dtype, generator=generator,
        vae_encoder=vae_encoder, random_full=random_full,
    )
    if random:
        return modules, tokenizer or get_tokenizer(None)

    from cvd_tpu_torch.io.checkpoints import load_sd_pipeline_weights

    loaded = load_sd_pipeline_weights(
        modules.unet, modules.vae, modules.clip, args.ori_model_path, clip_2=modules.clip_2,
        unet_subfolder=getattr(args, "unet_subfolder", None) or "unet",
        motion_module_ckpt=args.motion_module_ckpt,
        epi_module_ckpt=args.epi_module_ckpt,
        pose_adaptor_ckpt=args.pose_adaptor_ckpt,
        pose_encoder=modules.pose_encoder,
        motion_lora_ckpt=getattr(args, "motion_lora_ckpt", None),
        motion_lora_scale=getattr(args, "motion_lora_scale", 1.0),
        image_lora_ckpt=getattr(args, "image_lora_ckpt", None),
    )
    if getattr(args, "controlnet_ckpt", None):
        t0 = time.perf_counter()
        modules.controlnet = load_sparse_controlnet(
            args.controlnet_ckpt, modules.unet.config,
            bool(getattr(args, "controlnet_simplified_embedding", False)), device, dtype)
        loaded["controlnet"] = {"keys": len(modules.controlnet.state_dict()),
                                "seconds": time.perf_counter() - t0}
    # the civitai base model and its LoRA come last, as in the JAX package
    # (cvd_tpu/cli/build.py:245-252)
    if getattr(args, "civitai_base_model", None):
        from cvd_tpu_torch.io.ldm_convert import load_civitai_base_model

        t0 = time.perf_counter()
        keys = load_civitai_base_model(modules, args.civitai_base_model)
        loaded["civitai_base_model"] = {"keys": sum(keys.values()),
                                        "seconds": time.perf_counter() - t0}
    if getattr(args, "civitai_lora_ckpt", None):
        from cvd_tpu_torch.io.ldm_convert import apply_civitai_lora

        t0 = time.perf_counter()
        loaded["civitai_lora"] = {"keys": apply_civitai_lora(modules, args.civitai_lora_ckpt),
                                  "seconds": time.perf_counter() - t0}
    for name, r in loaded.items():
        print(f"[build] {name}: {r['keys']} keys in {r['seconds']:.2f} s", flush=True)
    if report is not None:
        report.update(loaded)
    return modules, tokenizer


def validate_ckpts(args, widths=SD15_WIDTHS) -> int:
    """--validate-ckpts dry run: route every checkpoint key (from the real
    files when paths are given, else the built-in manifests) onto the
    modules at ``widths`` (SD1.5's) on the ``meta`` device, WITHOUT allocating or loading
    weights. Prints one line per artifact; non-zero on any unmapped key."""
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import (
        clip_rename, image_lora_state, merge_torch_state, motion_module_state,
        sparse_controlnet_state, vae_legacy_rename,
    )
    from cvd_tpu_torch.io.torch_io import load_diffusers_folder_weights, load_torch_state

    pose_encoder_kwargs = None
    unet_cfg, vae_cfg, clip_cfg = widths
    if getattr(args, "model_config", None):
        from cvd_tpu_torch.io.model_config import load_model_config

        unet_cfg, pose_encoder_kwargs, _, _ = load_model_config(args.model_config,
                                                                base=unet_cfg)
    unet_cfg = unet_options(args, unet_cfg)
    m = PipelineModules.create(unet_cfg, vae_cfg, clip_cfg, device="meta", vae_encoder=True,
                               pose_encoder_kwargs=pose_encoder_kwargs)
    failures = 0

    def check(name, module, state, **kw):
        nonlocal failures
        try:
            consumed = merge_torch_state(module, state, **kw)
            extra = len(state) - len(consumed)
            status = "ok" if extra == 0 else f"{extra} keys unconsumed"
            failures += extra != 0
        except KeyError as e:
            status = " ".join(e.args[0].splitlines()[:2])
            failures += 1
        print(f"[validate-ckpts] {name}: {len(state)} keys -> {status}")

    def shapes_of(manifest):
        return {k: torch.empty(shape, device="meta") for k, shape in manifest.items()}

    if args.ori_model_path:
        sub = args.unet_subfolder or "unet"
        check("unet (folder)", m.unet,
              load_diffusers_folder_weights(os.path.join(args.ori_model_path, sub)))
        check("vae (folder)", m.vae,
              load_diffusers_folder_weights(os.path.join(args.ori_model_path, "vae")),
              rename=vae_legacy_rename)
        clip_state = load_diffusers_folder_weights(
            os.path.join(args.ori_model_path, "text_encoder"))
        check("text_encoder (folder)", m.clip,
              {k: v for k, v in clip_state.items() if "text_projection" not in k},
              rename=clip_rename)
    else:
        check("unet (manifest)", m.unet, shapes_of(M.sd15_unet_manifest()))
        check("vae (manifest)", m.vae, shapes_of(M.sd15_vae_manifest()),
              rename=vae_legacy_rename)
        check("text_encoder (manifest)", m.clip, shapes_of(M.sd15_clip_manifest()),
              rename=clip_rename)

    check("motion module", m.unet,
          motion_module_state(args.motion_module_ckpt, args.motion_lora_ckpt,
                              args.motion_lora_scale)
          if args.motion_module_ckpt else shapes_of(M.animatediff_v3_mm_manifest()))
    epi_manifest = M.cvd_epi_ckpt_manifest()
    if unet_cfg.sync_lora_rank and unet_cfg.sync_lora_scale:
        epi_manifest.update(M.cvd_sync_lora_manifest(
            unet_cfg.sync_lora_rank, abs(unet_cfg.spatial_lora_rank) or 4))
    check("epi module", m.unet,
          load_torch_state(args.epi_module_ckpt, "unet_trainable_dict")
          if args.epi_module_ckpt else shapes_of(epi_manifest))
    if args.pose_adaptor_ckpt:
        check("pose encoder", m.pose_encoder,
              load_torch_state(args.pose_adaptor_ckpt, "pose_encoder_state_dict"))
        check("pose qkv_merge", m.unet,
              load_torch_state(args.pose_adaptor_ckpt, "attention_processor_state_dict"))
    else:
        check("pose encoder", m.pose_encoder, shapes_of(M.cameractrl_pose_encoder_manifest()))
        check("pose qkv_merge", m.unet,
              shapes_of(M.cameractrl_attention_processor_manifest()))
    if getattr(args, "image_lora_ckpt", None):
        check("image lora", m.unet, image_lora_state(args.image_lora_ckpt))
    if getattr(args, "controlnet_ckpt", None):
        from cvd_tpu_torch.models.sparse_controlnet import SparseControlNetModel

        simplified = bool(getattr(args, "controlnet_simplified_embedding", False))
        with torch.device("meta"):
            controlnet = SparseControlNetModel(unet_cfg, 4 if simplified else 3,
                                               use_simplified_condition_embedding=simplified)
        state = sparse_controlnet_state(args.controlnet_ckpt)
        check("sparsectrl", controlnet, state)
        missing = set(dict(controlnet.named_parameters())) - set(state)
        if missing:
            failures += 1
            print(f"[validate-ckpts] sparsectrl: {len(missing)} parameters not in the file, "
                  f"e.g. {sorted(missing)[0]}")
    print(f"[validate-ckpts] {'FAILED' if failures else 'all artifacts map cleanly'}")
    return 1 if failures else 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--validate-ckpts", action="store_true", dest="validate",
                   help="dry-run checkpoint key routing against the "
                        "full-size parameter shapes (no weights loaded)")
    args = p.parse_args(argv)
    if args.validate:
        raise SystemExit(validate_ckpts(args))
    p.error("nothing to do (pass --validate-ckpts)")


if __name__ == "__main__":
    main()

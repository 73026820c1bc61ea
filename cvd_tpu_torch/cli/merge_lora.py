"""Offline LoRA fusion into SD UNet weights — tools/merge_lora2unet.py
(port of ``cvd_tpu/cli/merge_lora.py``).

    python -m cvd_tpu_torch.cli.merge_lora \
        --base_path <sd folder> --lora_ckpt <v3_sd15_adapter.ckpt> \
        --save_path <sd folder> --subfolder unet_webvidlora_v3 --lora_scale 1.0

Writes a new diffusers UNet subfolder with W += up @ down * scale fused into
the attention projections (merge_lora2unet.py:36-56), which
``--unet_subfolder`` then names. Runs on the host; needs ``safetensors``.
"""
from __future__ import annotations

import argparse
import os
import shutil


def main(args):
    from safetensors.torch import save_file

    from cvd_tpu_torch.io.lora import fuse_lora_into_unet_state
    from cvd_tpu_torch.io.torch_io import load_diffusers_folder_weights, load_torch_state

    unet_dir = os.path.join(args.base_path, "unet")
    state = load_diffusers_folder_weights(unet_dir)
    lora = load_torch_state(args.lora_ckpt)
    if not lora:  # the pairs nested under 'lora_state_dict'
        lora = load_torch_state(args.lora_ckpt, sub_dict="lora_state_dict")

    fused = fuse_lora_into_unet_state(state, lora, scale=args.lora_scale)

    out_dir = os.path.join(args.save_path, args.subfolder)
    os.makedirs(out_dir, exist_ok=True)
    save_file({k: v.contiguous() for k, v in fused.items()},
              os.path.join(out_dir, "diffusion_pytorch_model.safetensors"))
    cfg_src = os.path.join(unet_dir, "config.json")
    if os.path.exists(cfg_src):
        shutil.copy(cfg_src, os.path.join(out_dir, "config.json"))
    print(f"fused {len(lora)//2} LoRA pairs -> {out_dir}")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base_path", required=True)
    p.add_argument("--lora_ckpt", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--subfolder", default="unet_webvidlora_v3")
    p.add_argument("--lora_scale", type=float, default=1.0)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())

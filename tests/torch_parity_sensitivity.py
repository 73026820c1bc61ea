"""How much a prompt's token ids move the f32 parity of the 2-view sampler
between cvd_tpu_torch and cvd_tpu, on the CPU (no device is involved), in
the setup of ``tests/test_torch_lora.py::
test_image_lora_file_builds_through_both_packages_alike`` (tiny files in the
released layouts plus an image-LoRA file, built by both packages).

    JAX_PLATFORMS=cpu python tests/torch_parity_sensitivity.py [N]

For the test's prompts through the port's CRC-32 ``HashTokenizer``, then N
seeded random id sets, it prints the SNR of the final latents after 1 and 2
DDIM steps: the port (f32) against cvd_tpu (f32), and each of them against
the port in float64. Where both f32 runs are far from the float64 run, the
model amplifies f32 rounding for those ids; a port defect would leave
cvd_tpu close to float64 and the port far from it.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

import numpy as np


def _snr_db(got, want) -> float:
    return float(10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30)))


def main(n_random: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_checkpoints import model_args, write_tiny_checkpoints
    from test_torch_lora import OPTIONS, Fr, S, _perturbed, jax_modules
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE, tiny_modules

    from cvd_tpu.cli import build as jbuild
    from cvd_tpu.io import tokenizer as jtok
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline
    from cvd_tpu_torch.cli import build
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.io.tokenizer import HashTokenizer
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    torch.set_num_threads(1)
    base = tiny_modules(latent_size=S, video_length=Fr)
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        paths = write_tiny_checkpoints(root, _perturbed(base.unet_params, 10, 0.02),
                                       _perturbed(base.vae_params, 11, 0.02),
                                       _perturbed(base.clip_params, 12, 0.02),
                                       _perturbed(base.pose_encoder_params, 13, 0.02))
        lora = {k: v for k, v in state_dict_from_flax(jax_modules(**OPTIONS).unet_params).items()
                if "_lora." in k}
        paths["image_lora_ckpt"] = str(root / "image_lora.ckpt")
        torch.save({"lora_state_dict": lora}, paths["image_lora_ckpt"])
        args = model_args(paths, image_lora_rank=2)
        # cvd_tpu's build at the tiny widths, as the test patches it
        create = jbuild.PipelineModules.create
        jbuild.PipelineModules.create = lambda **kw: create(**{**kw, "fast_init": True})
        jbuild.UNetConfig = lambda **kw: dataclasses.replace(TINY_UNET, **kw)
        jbuild.VAEConfig = lambda: TINY_VAE
        jbuild.CLIPTextConfig = lambda: TINY_CLIP
        jbuild.enable_compilation_cache = lambda: None
        jtok.get_tokenizer = lambda folder: HashTokenizer()
        jm, _ = jbuild.build_modules(args, Fr, 8 * S)
        pm, _ = build.build_modules(args, torch.device("cpu"), tokenizer=HashTokenizer(),
                                    widths=build.SMOKE_WIDTHS)
    pm64 = copy.deepcopy(pm)
    for module in (pm64.unet, pm64.vae, pm64.clip, pm64.pose_encoder):
        module.double()

    rng = np.random.default_rng(8)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    lat0 = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    jpipe = JaxPipeline(jm, F_mat_size=256, rand_slope_ff=False, use_flash_kernel=False)
    prompts = [("the test's prompts, CRC-32", HashTokenizer()(["a parity scene"]),
                HashTokenizer()(["blurry"]))]
    draw = np.random.default_rng(0)
    for i in range(n_random):
        ids = np.full((1, 77), 49407, np.int32)
        neg = ids.copy()
        ids[0, :5] = [49406, *draw.integers(1, 49405, 3), 49407]
        neg[0, :3] = [49406, draw.integers(1, 49405), 49407]
        prompts.append((f"random ids {i}", ids, neg))
    t = torch.from_numpy
    for what, ids, neg in prompts:
        line = []
        for steps in (1, 2):
            want = np.asarray(jpipe(jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker),
                                    jnp.asarray(F_mats), num_inference_steps=steps,
                                    rng=jax.random.key(0), latents=jnp.asarray(lat0),
                                    decode=False))
            got = SimplePipeline(pm, F_mat_size=256, rand_slope_ff=False)(
                t(ids), t(neg), t(plucker), t(F_mats), num_inference_steps=steps,
                latents=t(lat0), decode=False).numpy()
            ref = SimplePipeline(pm64, F_mat_size=256, rand_slope_ff=False)(
                t(ids), t(neg), t(plucker).double(), t(F_mats).double(),
                num_inference_steps=steps, latents=t(lat0).double(), decode=False).numpy()
            line.append(f"{steps} step(s): port vs cvd_tpu {_snr_db(got, want):.2f} dB, "
                        f"cvd_tpu vs float64 {_snr_db(want, ref):.2f}, port vs float64 "
                        f"{_snr_db(got, ref):.2f}")
        print(f"{what}: " + "; ".join(line), flush=True)


if __name__ == "__main__":
    import jax

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    jax.config.update("jax_platforms", "cpu")
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12)

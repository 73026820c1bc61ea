"""The 2-view sampler end to end: cvd_tpu_torch against cvd_tpu's
SimplePipeline, and the port's CLI.

Both pipelines get the same weights (the JAX tiny bundle, every parameter
perturbed so the zero-initialized epi and pose-merge layers take part,
converted with state_dict_from_flax), the same token ids, Plücker maps,
F-matrices and pinned initial latents; first-frame pseudo lines are
horizontal (rand_slope_ff=False) on both sides. The bar is the one
cvd_tpu holds against its torch oracle: final latents at >= 60 dB SNR
(tests/test_reference_golden.py:823-825).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
        tree)


def _port_modules(jax_modules):
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.pipelines.common import PipelineModules

    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu")
    m.unet.load_state_dict(state_dict_from_flax(jax_modules.unet_params), strict=True)
    m.pose_encoder.load_state_dict(state_dict_from_flax(jax_modules.pose_encoder_params),
                                   strict=True)
    m.clip.load_state_dict(state_dict_from_flax(jax_modules.clip_params), strict=True)
    vae = {k: v for k, v in state_dict_from_flax(jax_modules.vae_params).items()
           if k.startswith(("decoder.", "post_quant_conv."))}
    m.vae.load_state_dict(vae, strict=True)
    return m


Fr, S = 2, 8  # frames, latent size


@pytest.fixture(scope="module")
def jax_bundle():
    """The JAX tiny bundle with perturbed UNet and pose-encoder params."""
    from tiny import tiny_modules

    base = tiny_modules(latent_size=S, video_length=Fr)
    params = _perturbed(base.unet_params, 0)
    return dataclasses.replace(base, unet_params=jax.tree_util.tree_map(jnp.asarray, params),
                               pose_encoder_params=_perturbed(base.pose_encoder_params, 1))


def test_simple_pipeline_latents_match_jax(jax_bundle):
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline
    from cvd_tpu_torch.io.tokenizer import HashTokenizer   # the same ids in every process
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    STEPS = 2
    jm = jax_bundle
    rng = np.random.default_rng(2)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    lat0 = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    tok = HashTokenizer()
    ids, neg = tok(["a parity scene"]), tok(["blurry"])

    want = np.asarray(JaxPipeline(jm, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), jnp.asarray(F_mats),
        num_inference_steps=STEPS, guidance_scale=8.5, rng=jax.random.key(0),
        latents=jnp.asarray(lat0), decode=False))

    pipe = SimplePipeline(_port_modules(jm), F_mat_size=256, rand_slope_ff=False)
    got = pipe(torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker),
               torch.from_numpy(F_mats), num_inference_steps=STEPS, guidance_scale=8.5,
               latents=torch.from_numpy(lat0), decode=False).numpy()
    assert got.shape == want.shape == (2, Fr, S, S, 4)
    assert len(pipe.unet_step_ms) == STEPS
    snr_db = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    assert snr_db >= 60.0, f"latent SNR {snr_db:.1f} dB < 60 dB"


def test_pose_adaptor_matches_jax(jax_bundle):
    """One pose-encoder + UNet call through PoseAdaptor on both sides.
    Tolerance 1e-4 of max |ref|: f32 on both sides, one UNet call, so only
    summation order differs."""
    from cvd_tpu.models.pose_adaptor import PoseAdaptor as JaxPoseAdaptor
    from cvd_tpu_torch.models.pose_adaptor import PoseAdaptor

    jm = jax_bundle
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, jm.unet.config.cross_attention_dim)).astype(np.float32)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    t = np.array([901, 401], dtype=np.int32)

    want, _ = JaxPoseAdaptor(jm, F_mat_size=256, rand_slope_ff=False)(
        jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(plucker),
        jnp.asarray(F_mats))
    want = np.asarray(want)
    with torch.no_grad():
        got = PoseAdaptor(_port_modules(jm), F_mat_size=256, rand_slope_ff=False)(
            torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
            torch.from_numpy(plucker), torch.from_numpy(F_mats)).numpy()
    assert got.shape == want.shape == (2, Fr, S, S, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_inference_cli_random_weights(tmp_path):
    """The port's CLI as a user runs it, tiny random weights, on the CPU."""
    from cvd_tpu_torch.cli import inference

    args = inference.build_parser().parse_args([
        "--random-weights", "--device", "cpu", "--image_height", "64",
        "--image_width", "64", "--video_length", "2", "--num_inference_steps", "2",
        "--caption_file", os.path.join(ASSETS, "example_prompts.json"),
        "--use_negative_prompt",
        "--pose_file_0", os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
        "--pose_file_1", os.path.join(ASSETS, "pose_files", "example_arc.txt"),
        "--out_root", str(tmp_path),
    ])
    records = inference.main(args)
    assert len(records) == 2
    for idx, rec in enumerate(records):
        v = rec["videos"]
        assert len(rec["unet_step_ms"]) == 2 and rec["seconds"] > 0
        assert v.shape == (2, 2, 64, 64, 3) and np.isfinite(v).all()
        saved = np.load(tmp_path / str(idx) / "videos.npy")
        assert saved.dtype == np.uint8 and saved.shape == (2, 2, 64, 64, 3)


def test_multidiff_windows_are_refused():
    """Multidiff windows that do not tile the video are refused by name (2
    frames cannot be 2 windows overlapping by the default 12), as is a video
    longer than the pose encoder's positional encoding; the windows that do
    tile it are tests/test_torch_multidiff.py's."""
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    ids = torch.zeros(1, 77, dtype=torch.int32)
    with pytest.raises(ValueError, match="frames must equal"):
        SimplePipeline(m)(ids, ids, torch.zeros(2, 2, 64, 64, 6), torch.zeros(2, 2, 3, 3),
                          multidiff_total_steps=2)
    with pytest.raises(ValueError, match="positional encoding holds 16"):
        SimplePipeline(m)(ids, ids, torch.zeros(2, 18, 64, 64, 6), torch.zeros(2, 18, 3, 3),
                          multidiff_total_steps=2, multidiff_overlaps=2)


def test_entry_points_refuse_a_silent_cpu_run(monkeypatch, tmp_path):
    """With no card and no device asked for, the CLIs raise instead of
    running on the CPU; asked for the CPU, they take it."""
    from cvd_tpu_torch.cli import build, inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        build.resolve_device(None)
    assert build.resolve_device("cpu") == torch.device("cpu")
    args = inference.build_parser().parse_args([
        "--random-weights", "--image_height", "64", "--image_width", "64",
        "--video_length", "2", "--num_inference_steps", "1",
        "--caption_file", os.path.join(ASSETS, "example_prompts.json"),
        "--pose_file_0", os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
        "--pose_file_1", os.path.join(ASSETS, "pose_files", "example_arc.txt"),
        "--out_root", str(tmp_path),
    ])
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(args)
    assert not os.listdir(tmp_path)   # refused before anything was written


def test_default_device_is_the_card(monkeypatch):
    from cvd_tpu_torch.cli import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert build.resolve_device(None) == torch.device("cuda")
    assert build.resolve_device("cpu") == torch.device("cpu")

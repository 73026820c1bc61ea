"""Multidiff sliding windows of the 2-view sampler: cvd_tpu_torch against
cvd_tpu, on the CPU in f32 at tiny widths, and the inference CLI's
``--multidiff_*`` and ``--pab`` options as a user runs them.

Two windows of 2 frames overlapping by 1 make a 3-frame video, as in
cvd_tpu's own multidiff test (tests/test_pipelines.py). Both samplers get
the same weights (cvd_tpu's fast init, converted), inputs and initial
latents; the bar is final latents at >= 60 dB SNR, as in
tests/test_torch_slice.py. The pose encoder sees every frame of the video,
so the frame count is bounded by its temporal positional encoding (16 in
the released config), in cvd_tpu too: the port refuses a longer video by
name.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_advanced import _prompt_ids  # noqa: E402
from test_torch_lora import jax_modules, port_modules  # noqa: E402

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
S, IMG = 8, 64
WINDOW, OVERLAP, WINDOWS = 2, 1, 2
FRAMES = WINDOWS * (WINDOW - OVERLAP) + OVERLAP   # 3


def _snr_db(got, want):
    return 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))


@pytest.fixture(scope="module")
def bundles():
    jm = jax_modules()
    return jm, port_modules(jm)


def _inputs(frames=FRAMES, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, frames, IMG, IMG, 6)).astype(np.float32),
            (rng.standard_normal((2, frames, 3, 3)) * 1e-3).astype(np.float32),
            rng.standard_normal((2, frames, S, S, 4)).astype(np.float32))


def _port_run(pm, frames=FRAMES, **kw):
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    plucker, F_mats, lat0 = _inputs(frames)
    ids, neg = _prompt_ids()
    pipe = SimplePipeline(pm, F_mat_size=256, rand_slope_ff=False)
    out = pipe(torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker),
               torch.from_numpy(F_mats), num_inference_steps=2, latents=torch.from_numpy(lat0),
               decode=False, **kw)
    return out, pipe


def test_two_windows_match_jax(bundles):
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline

    jm, pm = bundles
    plucker, F_mats, lat0 = _inputs()
    ids, neg = _prompt_ids()
    want = np.asarray(JaxPipeline(jm, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), jnp.asarray(F_mats),
        num_inference_steps=2, rng=jax.random.key(0), latents=jnp.asarray(lat0), decode=False,
        multidiff_total_steps=WINDOWS, multidiff_overlaps=OVERLAP, window_length=WINDOW))
    # the window length follows from the frames, the windows and the overlap
    got, pipe = _port_run(pm, multidiff_total_steps=WINDOWS, multidiff_overlaps=OVERLAP)
    assert got.shape == want.shape == (2, FRAMES, S, S, 4)
    assert len(pipe.unet_step_ms) == 2 * WINDOWS            # a UNet call per window and step
    assert _snr_db(got.numpy(), want) >= 60.0, f"SNR {_snr_db(got.numpy(), want):.1f} dB"


@pytest.mark.parametrize("frames,kw,match", [
    (17, dict(), "positional encoding holds 16"),
    (4, dict(multidiff_total_steps=2, multidiff_overlaps=1), "frames must equal"),
    (FRAMES, dict(multidiff_total_steps=2, multidiff_overlaps=1, pab_config="default"),
     "PAB \\+ multidiff"),
])
def test_refusals(bundles, frames, kw, match):
    """A video longer than the pose encoder's 16 frames, windows that do not
    tile the frames, and PAB with windows: each raises before a UNet call."""
    from cvd_tpu_torch.pipelines.pab import PABConfig

    if kw.get("pab_config") == "default":
        kw["pab_config"] = PABConfig()
    _, pm = bundles
    calls = []
    handle = pm.unet.register_forward_hook(lambda *a: calls.append(1))
    try:
        with pytest.raises(ValueError, match=match):
            _port_run(pm, frames, **kw)
    finally:
        handle.remove()
    assert not calls


def _cli_args(tmp_path, *extra):
    from cvd_tpu_torch.cli import inference

    return inference.build_parser().parse_args([
        "--random-weights", "--device", "cpu", "--image_height", "64", "--image_width", "64",
        "--video_length", str(WINDOW), "--num_inference_steps", "2",
        "--caption_file", os.path.join(ASSETS, "example_prompts.json"),
        "--pose_file_0", os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
        "--pose_file_1", os.path.join(ASSETS, "pose_files", "example_arc.txt"),
        "--out_root", str(tmp_path), *extra])


def test_inference_cli_multidiff(tmp_path):
    """--video_length is the window: the pose files give the whole video."""
    from cvd_tpu_torch.cli import inference

    records = inference.main(_cli_args(tmp_path, "--multidiff_total_steps", str(WINDOWS),
                                       "--multidiff_overlaps", str(OVERLAP)))
    assert len(records) == 2
    for idx, rec in enumerate(records):
        assert rec["videos"].shape == (2, FRAMES, 64, 64, 3) and np.isfinite(rec["videos"]).all()
        assert len(rec["unet_step_ms"]) == 2 * WINDOWS
        assert np.load(tmp_path / str(idx) / "videos.npy").shape == (2, FRAMES, 64, 64, 3)


def test_inference_cli_pab(tmp_path):
    from cvd_tpu_torch.cli import inference

    records = inference.main(_cli_args(tmp_path, "--num_inference_steps", "5", "--pab",
                                       "--pab_ranges", "spatial=2,cross=2,temporal=2,epi=2"))
    assert all(r["videos"].shape == (2, WINDOW, 64, 64, 3) and len(r["unet_step_ms"]) == 5
               for r in records)
    with pytest.raises(ValueError, match="PAB \\+ multidiff"):
        inference.main(_cli_args(tmp_path / "both", "--pab", "--multidiff_total_steps", "2",
                                 "--multidiff_overlaps", "1"))
    assert not (tmp_path / "both").exists()

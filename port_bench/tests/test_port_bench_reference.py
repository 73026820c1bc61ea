"""The reference against the program's plain paths (the CPU's), at the
tiny configuration's widths in float32: the same state-dict keys, the same
forward of every model, the same whole 2-view request, and the same
training loss and epi gradients, from the same weights and draws. The test
imports both; the reference itself imports nothing of the program."""
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from port_bench.lib import names, port, weights
from port_bench.reference import model as ref_model
from port_bench.reference import sampling, training

TINY = names.config("tiny-cpu")
SEED = 3_000_000_019


def _close(a, b, tol):
    a, b = a.detach().double(), b.detach().double()
    assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("config", ["tiny-cpu", "cvd-sd15-256-sample", "cvd-sd15-256-train"])
@pytest.mark.parametrize("encoder", [False, True])
def test_same_keys_and_shapes(config, encoder):
    cfg = names.config(config)
    arch = names.architecture(cfg["architecture"])
    program = arch.program(cfg, "meta", encoder)
    table = weights.shapes(arch.reference(cfg, "meta", encoder))
    for name, shapes in table.items():
        got = getattr(program, name).state_dict()
        assert {k: tuple(t.shape) for k, t in got.items()} == shapes


def test_pose_encoder_takes_the_configured_channels():
    """The program's ``create`` ties the pose encoder's widths to the UNet's;
    a configuration that states others gets them, as the reference does."""
    cfg = dict(TINY, pose_encoder=dict(TINY["pose_encoder"], channels=[16, 32, 48, 64]))
    arch = names.architecture(cfg["architecture"])
    program = arch.program(cfg, "cpu")
    got = {k: tuple(t.shape) for k, t in program.pose_encoder.state_dict().items()}
    assert got == weights.shapes(arch.reference(cfg, "meta"))["pose_encoder"]
    assert got["encoder_conv_in.weight"][0] == 16
    p = next(program.pose_encoder.parameters())
    assert p.dtype == torch.float32 and not p.requires_grad and not program.pose_encoder.training
    assert tuple(program.unet.config.block_out_channels) == (32, 64, 64, 64)


@pytest.fixture(scope="module")
def both():
    return port.build_modules(TINY, SEED, "cpu"), port.reference_modules(TINY, SEED, "cpu")


def test_models_forward(both):
    from cvd_tpu_torch.models.epi import EpiConditioning

    prog, ref = both
    g = torch.Generator().manual_seed(1)
    B, Fr, S = 4, 4, 128
    x = torch.randn(B, Fr, S // 8, S // 8, 4, generator=g)
    text = torch.randn(B, 77, TINY["unet"]["cross_attention_dim"], generator=g)
    plucker = torch.randn(2, Fr, S, S, 6, generator=g)
    F_mats = torch.randn(B * Fr, 3, 3, generator=g)
    ids = torch.randint(0, 49408, (2, 77), generator=g)
    z = torch.randn(3, 16, 16, 4, generator=g)
    with torch.no_grad():
        pose = prog.pose_encoder(plucker)
        for a, b in zip(pose, ref["pose_encoder"](plucker)):
            _close(a, b, 1e-5)
        pose4 = [torch.cat([p[:1], p[:1], p[1:], p[1:]]) for p in pose]
        out = prog.unet(x, torch.tensor(500), text, pose4, EpiConditioning(
            F_mats=F_mats, video_length=Fr, F_mat_size=128, rand_slope_ff=True,
            generator=torch.Generator().manual_seed(5)))
        want = ref["unet"](x, torch.full((B,), 500), text, pose4, ref_model.EpiCond(
            F_mats, Fr, 128, generator=torch.Generator().manual_seed(5)))
        _close(out, want, 1e-5)
        _close(prog.clip(ids), ref["clip"](ids), 1e-5)
        _close(prog.vae.decode(z), ref["vae"].decode(z), 1e-5)


def test_whole_request(both):
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    from port_bench.reference import geometry
    from port_bench.traffic import generate

    prog, ref = both
    mix = names.traffic("tiny-pair")
    spec = generate.request(mix, 77, generate.captions(mix))
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for v, text in enumerate(spec["poses"]):
            paths.append(os.path.join(d, f"{v}.txt"))
            open(paths[-1], "w").write(text)
        from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded

        sample = ValRealEstate10KPoseFolded([spec["prompt"]], paths[0], paths[1],
                                            sample_n_frames=4, sample_size=128)[0]
        plucker, F_mats = geometry.pair_conditioning(paths[0], paths[1], 4, 128)
    np.testing.assert_allclose(plucker, sample["plucker_embedding"].reshape(plucker.shape),
                               atol=1e-5)
    np.testing.assert_allclose(F_mats, sample["F_mats"].reshape(F_mats.shape), rtol=1e-5,
                               atol=1e-6)
    ids = torch.from_numpy(generate.tokenize([spec["prompt"]]))
    neg = torch.from_numpy(generate.tokenize([spec["negative"]]))
    latents = torch.randn(2, 4, 16, 16, 4, generator=torch.Generator().manual_seed(3))
    videos = SimplePipeline(prog, F_mat_size=128, capture=False)(
        ids, neg, torch.from_numpy(plucker), torch.from_numpy(F_mats), num_inference_steps=3,
        guidance_scale=8.5, generator=torch.Generator().manual_seed(11), latents=latents)
    want = sampling.request(ref, TINY, ids, neg, torch.from_numpy(plucker),
                            torch.from_numpy(F_mats), latents,
                            torch.Generator().manual_seed(11), 3, 8.5)
    # f32 rounding (CLIP scales its logits by a reciprocal here, divides there)
    # grows through 3 guided steps: 1e-3 of a pixel in [0, 1] bounds it
    _close(videos, want, 1e-3)


def test_training_loss_and_epi_gradients():
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    prog = port.build_modules(TINY, SEED, "cpu", vae_encoder=True, unet_dtype=torch.float32)
    state = create_train_state(prog.unet, frozen_dtype=torch.float32)
    ref = port.reference_modules(TINY, SEED, "cpu", vae_encoder=True)
    g = torch.Generator().manual_seed(2)
    B, Fr, S = 2, 4, 128
    batch = {"pixel_values": torch.rand(B, Fr, S, S, 3, generator=g) * 2 - 1,
             "plucker": torch.randn(B, Fr, S, S, 6, generator=g),
             "F_mats": torch.randn(B, Fr, 3, 3, generator=g),
             "text_ids": torch.randint(0, 49408, (B, 77), generator=g)}
    loss, _ = loss_and_grads(state, batch, prog, torch.Generator().manual_seed(9),
                             F_mat_size=128, remat=False)
    params = training.trainable(ref)
    for p in params.values():
        p.requires_grad_(True)
    want = training.loss(ref, TINY, batch, torch.Generator().manual_seed(9), torch.float32)
    want.backward()
    assert math.isclose(float(loss), float(want), rel_tol=1e-5)
    got = dict(zip(state.trainable, state.trainable_params()))
    assert set(got) == set(params)
    scale = max(float(p.grad.norm()) for p in params.values())
    for k, p in params.items():
        _close(got[k].grad / scale, p.grad / scale, 1e-4)

"""The runtime image LoRA, the sync-LoRA and spatial extended attention:
cvd_tpu_torch against cvd_tpu, on the CPU in f32 at tiny widths.

Both sides get the same weights: cvd_tpu's Flax init with every parameter
perturbed (so every LoRA ``up`` is nonzero: a zero ``up`` proves nothing),
converted with ``state_dict_from_flax``. Modules agree to 1e-5 x max(1,
max |ref|); the 2-view sampler's final latents at >= 60 dB SNR (the bar of
tests/test_torch_slice.py); one training step's loss to 1e-5 relative and
its trainable gradients at >= 60 dB.
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

from test_torch_modules import port, t  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
Fr, S = 2, 8  # frames, latent size
OPTIONS = dict(spatial_lora_rank=-2, sync_lora_rank=4, sync_lora_scale=0.8,
               spatial_extended_attention=True)


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), f"{what}: max err {err:.3g}"


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.standard_normal(a.shape) * scale, jnp.float32),
        tree)


# ------------------------------------------------------------------ modules

def test_attention_lora_matches_jax():
    from cvd_tpu.models.layers import Attention as JA
    from cvd_tpu_torch.models.layers import Attention as PA

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    for context, cross in ((None, None), (ctx, 24)):
        jm = JA(16, heads=2, dim_head=8, cross_attention_dim=cross, lora_rank=4)
        args = (jnp.asarray(x),) + (() if context is None else (jnp.asarray(context),))
        v = _perturbed(jm.init(jax.random.key(0), *args), 1)
        assert np.abs(np.asarray(v["params"]["to_q_lora"]["up"]["kernel"])).max() > 0
        want = jm.apply(v, *args, lora_scale=0.7)
        pm = port(PA(16, 2, 8, cross_attention_dim=cross, lora_rank=4), v)
        with torch.no_grad():
            got = pm(t(x), None if context is None else t(context), lora_scale=0.7)
        close(got, want, f"attention lora, context {cross}")


@pytest.mark.parametrize("extended,lora", [(False, 4), (True, 0), (True, 4)],
                         ids=["lora", "extended", "both"])
def test_transformer_block_matches_jax(extended, lora):
    from cvd_tpu.models.layers import BasicTransformerBlock as JB
    from cvd_tpu_torch.models.layers import BasicTransformerBlock as PB

    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((4, 7, 24)).astype(np.float32)
    jm = JB(32, 4, 8, cross_attention_dim=24, extended_attention=extended, lora_rank=lora)
    v = _perturbed(jm.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(ctx)), 2)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(ctx), lora_scale=0.6)
    pm = port(PB(32, 4, 8, 24, extended_attention=extended, lora_rank=lora), v)
    assert not pm.fused
    with torch.no_grad():
        close(pm(t(x), t(ctx), lora_scale=0.6), want, f"block extended={extended} lora={lora}")


def test_extended_attention_takes_the_fused_kernel_where_the_reference_does(monkeypatch):
    """Lq 256, Lk 512 (multiples of 128) is a K2 site; Lq 64 is not."""
    from cvd_tpu_torch.models import layers

    calls = []
    monkeypatch.setattr(layers, "flash_attention",
                        lambda q, k, v, heads: calls.append(k.shape[1]) or
                        layers.merge_heads(layers.attention_with_bias(
                            *(layers.split_heads(a, heads) for a in (q, k, v)), None)))
    blk = layers.BasicTransformerBlock(32, 4, 8, 24, extended_attention=True).eval()
    with torch.no_grad():
        for L in (256, 64):
            blk(torch.randn(2, L, 32), torch.randn(2, 7, 24))
    assert calls == [512]


def test_temporal_attention_sync_lora_matches_jax():
    from cvd_tpu.models.motion import TemporalSelfAttention as JT
    from cvd_tpu_torch.models.motion import TemporalSelfAttention as PT

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pose = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    jm = JT(32, 4, pose_conditioned=True, sync_lora_rank=4, sync_lora_scale=0.8)
    v = _perturbed(jm.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(pose)), 3)
    assert "to_out_lora_sync" in v["params"]
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(pose))
    pm = port(PT(32, 4, pose_conditioned=True, sync_lora_rank=4, sync_lora_scale=0.8), v)
    assert "processor.to_q_lora_sync.down.weight" in pm.state_dict()
    with torch.no_grad():
        close(pm(t(x), t(pose)), want, "temporal sync-LoRA")


# --------------------------------------------------------- the UNet and the bundle

def jax_modules(**unet_options):
    """cvd_tpu's tiny bundle with ``unet_options``, every tensor drawn (its
    fast init: no Flax init to trace, and every LoRA ``up`` nonzero)."""
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    from cvd_tpu.pipelines.common import PipelineModules

    return PipelineModules.create(unet_config=dataclasses.replace(TINY_UNET, **unet_options),
                                  vae_config=TINY_VAE, clip_config=TINY_CLIP,
                                  latent_size=S, video_length=Fr, fast_init=True)


def port_modules(jm):
    """The port's tiny bundle holding ``jm``'s weights."""
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_VAE
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.pipelines.common import PipelineModules

    fields = {f.name for f in dataclasses.fields(UNetConfig)}
    cfg = UNetConfig(**{k: v for k, v in dataclasses.asdict(jm.unet.config).items()
                        if k in fields})
    m = PipelineModules.create(cfg, SMOKE_VAE, SMOKE_CLIP, device="cpu")
    for name, tree in (("unet", jm.unet_params), ("clip", jm.clip_params),
                       ("pose_encoder", jm.pose_encoder_params)):
        getattr(m, name).load_state_dict(
            state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree)), strict=True)
    vae = {k: v for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jm.vae_params)).items()
        if k.startswith(("decoder.", "post_quant_conv."))}
    m.vae.load_state_dict(vae, strict=True)
    return m


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_modules(**OPTIONS)


@pytest.fixture(scope="module")
def port_bundle(jax_bundle):
    return port_modules(jax_bundle)


def test_unet_with_all_three_matches_jax(jax_bundle, port_bundle):
    from cvd_tpu.models.epi import EpiConditioning as JC
    from cvd_tpu_torch.models.epi import EpiConditioning as PC

    sd = port_bundle.unet.state_dict()
    ups = [k for k in sd if k.endswith(("_lora.up.weight", "_lora_sync.up.weight"))]
    n_motion = sum(k.endswith("temporal_transformer.proj_out.weight") for k in sd)
    assert len([k for k in ups if "sync" in k]) == 4 * n_motion and all(sd[k].any() for k in ups)
    # sync ranks: channels // |spatial_lora_rank| (the reference's divisor)
    assert sd["down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0."
              "attention_blocks.0.processor.to_q_lora_sync.down.weight"].shape == (16, 32)
    rng = np.random.default_rng(6)
    B = 4
    lat = rng.standard_normal((B, Fr, S, S, 4)).astype(np.float32)
    ctx = rng.standard_normal((B, 77, 24)).astype(np.float32)
    F_mats = (rng.standard_normal((B * Fr, 3, 3)) * 1e-3).astype(np.float32)
    pose = [rng.standard_normal((B, Fr, S >> i, S >> i, c)).astype(np.float32)
            for i, c in enumerate((32, 64, 64, 64))]
    ts = np.array([901, 901, 401, 401], np.int32)
    kw = dict(video_length=Fr, F_mat_size=256, rand_slope_ff=False, cfg_factor=2)
    cond = JC(F_mats=jnp.asarray(F_mats), use_flash_kernel=False, **kw)
    want = jax.jit(lambda p, *a: jax_bundle.unet.apply(p, *a, cond, lora_scale=0.75)[0])(
        jax_bundle.unet_params, jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
        [jnp.asarray(p) for p in pose])
    with torch.no_grad():
        got = port_bundle.unet(t(lat), t(ts), t(ctx), [t(p) for p in pose],
                               PC(F_mats=t(F_mats), **kw), lora_scale=0.75)
    close(got, want, "unet with image LoRA, sync-LoRA and extended attention")


def test_simple_pipeline_with_the_options_matches_jax(jax_bundle, port_bundle):
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline
    from cvd_tpu_torch.io.tokenizer import HashTokenizer   # the same ids in every process
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    rng = np.random.default_rng(7)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    lat0 = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    tok = HashTokenizer()
    ids, neg = tok(["a parity scene"]), tok(["blurry"])
    want = np.asarray(JaxPipeline(jax_bundle, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), jnp.asarray(F_mats),
        num_inference_steps=2, rng=jax.random.key(0), latents=jnp.asarray(lat0), decode=False))
    got = SimplePipeline(port_bundle, F_mat_size=256, rand_slope_ff=False)(
        t(ids), t(neg), t(plucker), t(F_mats), num_inference_steps=2, latents=t(lat0),
        decode=False).numpy()
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    assert snr >= 60.0, f"latent SNR {snr:.1f} dB < 60 dB"


# ------------------------------------------------------------------ training

def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32),
            "text_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32),
            "plucker": rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32),
            "F_mats": (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)}


def test_train_step_with_both_loras_matches_jax(jax_bundle, port_bundle):
    """Loss to 1e-5 relative, trainable gradients at >= 60 dB; an AdamW step
    moves every sync-LoRA tensor and no image-LoRA tensor."""
    import optax

    from cvd_tpu.train.state import TrainState
    from cvd_tpu.train.train_step import train_step as jax_train_step
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    jm, tx = jax_bundle, optax.sgd(1.0)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=jm.unet_params,
                        opt_state=tx.init(jm.unet_params), tx=tx)
    key = jax.random.key(7)
    new, metrics = jax.jit(lambda s, b, k: jax_train_step(
        s, b, jm, k, rand_slope_ff=False, use_flash_kernel=False, remat=False))(
        jstate, {k: jnp.asarray(v) for k, v in _batch().items()}, key)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), jm.unet_params, new.params))
    _, eps_key, t_key, _, _ = jax.random.split(key, 5)
    noise = np.asarray(jax.random.normal(eps_key, (2, Fr, S, S, 4), jnp.float32))
    timesteps = np.asarray(jax.random.randint(t_key, (2,), 0, 1000))

    unet = port_bundle.unet
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    state = create_train_state(unet, learning_rate=1e-3)
    try:
        loss, _ = loss_and_grads(state, {k: t(v) for k, v in _batch().items()}, port_bundle,
                                 noise=t(noise), timesteps=t(timesteps), F_mat_size=256,
                                 rand_slope_ff=False, remat=True)
        assert abs(float(loss) - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
        params = dict(unet.named_parameters())
        sync = [n for n in state.trainable if "_lora_sync." in n]
        image = [n for n in params if "_lora." in n]
        n_motion = sum(n.endswith("temporal_transformer.proj_out.weight") for n in params)
        assert len(sync) == 8 * n_motion and image and not set(image) & set(state.trainable)
        got = np.concatenate([params[n].grad.numpy().ravel() for n in state.trainable])
        ref = np.concatenate([want[n].numpy().ravel() for n in state.trainable])
        assert _snr_db(got, ref) >= 60.0, f"gradient SNR {_snr_db(got, ref):.1f} dB"
        state.apply_gradients()
        assert all(not torch.equal(params[n], before[n]) for n in sync)
        assert all(torch.equal(params[n], before[n]) for n in image)
    finally:
        with torch.no_grad():   # the module-scoped bundle goes back as it was
            for n, p in unet.named_parameters():
                p.copy_(before[n])
                p.requires_grad_(False)
                p.grad = None


# ------------------------------------------------------------------- loading

def test_image_lora_file_builds_through_both_packages_alike(jax_bundle, tmp_path, monkeypatch):
    """Tiny files in the released layouts plus an image-LoRA file keyed as
    CameraCtrl's (``...attn1.processor.to_q_lora.down.weight``, under
    ``lora_state_dict``): cvd_tpu's and the port's ``build_modules`` give
    the same UNet parameters and the same latents (>= 60 dB)."""
    from test_torch_checkpoints import model_args, write_tiny_checkpoints
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE, tiny_modules

    from cvd_tpu.cli import build as jbuild
    from cvd_tpu.io import tokenizer as jtok
    from cvd_tpu.io.tokenizer import HashTokenizer
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline
    from cvd_tpu_torch.cli import build
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    base = tiny_modules(latent_size=S, video_length=Fr)
    paths = write_tiny_checkpoints(tmp_path, _perturbed(base.unet_params, 10, 0.02),
                                   _perturbed(base.vae_params, 11, 0.02),
                                   _perturbed(base.clip_params, 12, 0.02),
                                   _perturbed(base.pose_encoder_params, 13, 0.02))
    lora = {k: v for k, v in state_dict_from_flax(jax_bundle.unet_params).items()
            if "_lora." in k}
    assert lora and all(".processor.to_" in k for k in lora)
    paths["image_lora_ckpt"] = str(tmp_path / "image_lora.ckpt")
    torch.save({"lora_state_dict": lora}, paths["image_lora_ckpt"])
    args = model_args(paths, image_lora_rank=2)

    # cvd_tpu's build at the tiny widths, with no compilation cache and the hash
    # tokenizer; its modules from the fast init (the files fill every tensor)
    create = jbuild.PipelineModules.create
    monkeypatch.setattr(jbuild.PipelineModules, "create",
                        lambda **kw: create(**{**kw, "fast_init": True}))
    monkeypatch.setattr(jbuild, "UNetConfig", lambda **kw: dataclasses.replace(TINY_UNET, **kw))
    monkeypatch.setattr(jbuild, "VAEConfig", lambda: TINY_VAE)
    monkeypatch.setattr(jbuild, "CLIPTextConfig", lambda: TINY_CLIP)
    monkeypatch.setattr(jbuild, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jtok, "get_tokenizer", lambda folder: HashTokenizer())
    jm, _ = jbuild.build_modules(args, Fr, 8 * S)
    pm, _ = build.build_modules(args, torch.device("cpu"), tokenizer=HashTokenizer(),
                                widths=build.SMOKE_WIDTHS)
    want_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jm.unet_params))
    got_sd = pm.unet.state_dict()
    assert set(got_sd) == set(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in got_sd)
    assert all(torch.equal(got_sd[k], v) for k, v in lora.items())

    rng = np.random.default_rng(8)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    lat0 = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    # the port's tokenizer hashes with CRC-32: the same ids in every process
    # (cvd_tpu's salts Python's hash per process: a test's inputs would change
    # from one worker to the next, and with them its SNR)
    from cvd_tpu_torch.io.tokenizer import HashTokenizer as PortTokenizer

    ids, neg = PortTokenizer()(["a parity scene"]), PortTokenizer()(["blurry"])
    want = np.asarray(JaxPipeline(jm, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), jnp.asarray(F_mats),
        num_inference_steps=2, rng=jax.random.key(0), latents=jnp.asarray(lat0), decode=False))
    got = SimplePipeline(pm, F_mat_size=256, rand_slope_ff=False)(
        t(ids), t(neg), t(plucker), t(F_mats), num_inference_steps=2, latents=t(lat0),
        decode=False).numpy()
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    assert snr >= 60.0, f"latent SNR {snr:.1f} dB < 60 dB"

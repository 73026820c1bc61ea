"""cvd_tpu_torch modules against their cvd_tpu (JAX) counterparts.

Each test builds the JAX module at a tiny width, converts its params with
``cvd_tpu_torch.io.from_flax.state_dict_from_flax``, loads them strictly
into the port's module, feeds both the same numpy inputs and compares.
Tolerance: modules in f32 agree to 1e-4 relative to max |ref| (the bar of
the JAX package's own golden tests, test_reference_golden.py:24-25); the
remaining difference is summation order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvd_tpu_torch.io.from_flax import state_dict_from_flax

torch.set_num_threads(1)

REL_TOL = 1e-4


def close(got, want, what="", rel=REL_TOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want))) or 1.0
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} * {scale:.3g}"


def port(module, variables):
    module.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)),
                           strict=True)
    return module.eval()


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ layers

def test_transformer2d_matches_jax():
    from cvd_tpu.models.layers import Transformer2DModel as JT
    from cvd_tpu_torch.models.layers import Transformer2DModel as PT

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    jm = JT(32, heads=4, dim_head=8, cross_attention_dim=24, groups=8)
    v = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(ctx))
    pm = port(PT(32, 4, 8, cross_attention_dim=24, groups=8), v)
    with torch.no_grad():
        close(pm(t(x), t(ctx)), want, "transformer2d")


def test_attention_self_matches_jax():
    """Self-attention long enough for the fused-kernel site (L >= 256)."""
    from cvd_tpu.models.layers import Attention as JA
    from cvd_tpu_torch.models.layers import Attention as PA

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 256, 16)).astype(np.float32)
    jm = JA(16, heads=2, dim_head=8)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    pm = port(PA(16, 2, 8), v)
    with torch.no_grad():
        close(pm(t(x)), want, "attention")


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resnet_block_matches_jax(cin, cout):
    from cvd_tpu.models.layers import ResnetBlock2D as JR
    from cvd_tpu_torch.models.layers import ResnetBlock2D as PR

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    temb = rng.standard_normal((2, 40)).astype(np.float32)
    jm = JR(cout, temb_channels=40, groups=8)
    v = jm.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(temb))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(temb))
    pm = port(PR(cin, cout, 40, groups=8), v)
    with torch.no_grad():
        close(pm(t(x), t(temb)), want, "resnet")


def test_timestep_embedding_matches_jax():
    from cvd_tpu.models.layers import sinusoidal_time_embedding as js
    from cvd_tpu_torch.models.layers import sinusoidal_time_embedding as ps

    ts = np.array([1, 251, 999], np.int32)
    close(ps(t(ts), 320), js(jnp.asarray(ts), 320), "time embedding")


# ------------------------------------------------------------------ motion

@pytest.mark.parametrize("pixels", [16, 128])
def test_temporal_transformer_matches_jax(pixels):
    """Motion module with the pose-conditioned first attention; 128 pixels
    is a fused-kernel site in both packages."""
    from cvd_tpu.models.motion import TemporalTransformer as JT
    from cvd_tpu_torch.models.motion import TemporalTransformer as PT

    H, W = {16: (4, 4), 128: (8, 16)}[pixels]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, H, W, 32)).astype(np.float32)
    pose = rng.standard_normal((2, 4, H, W, 32)).astype(np.float32)
    jm = JT(32, heads=4, norm_groups=8)
    v = jm.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(pose))
    # qkv_merge is zero-initialized; give it weights so the pose path counts
    v = jax.tree_util.tree_map(lambda a: a + 0.05, v)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(pose))
    pm = port(PT(32, heads=4, norm_groups=8), v)
    with torch.no_grad():
        close(pm(t(x), t(pose)), want, "temporal transformer")


# --------------------------------------------------------------------- epi

def _epi_pair(feat, rand_slope_ff, monkeypatch, slope=1.1):
    from cvd_tpu.models import epi as jepi
    from cvd_tpu_torch.models import epi as pepi

    B, Fw, C, HEADS = 2, 4, 32, 4
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, Fw, feat, feat, C)).astype(np.float32)
    F_mats = (rng.standard_normal((B * Fw, 3, 3)) * 1e-3).astype(np.float32)
    monkeypatch.setattr(jepi, "_uniform_slope",
                        lambda rng_, shape: jnp.full(shape, slope, jnp.float32))
    monkeypatch.setattr(pepi, "_uniform_slope",
                        lambda gen, shape, device: torch.full(shape, slope))
    jm = jepi.EpiTransformer(in_channels=C, heads=HEADS, norm_groups=8,
                             zero_initialize=False)
    jcond = jepi.EpiConditioning(F_mats=jnp.asarray(F_mats), video_length=Fw,
                                 F_mat_size=256, rand_slope_ff=rand_slope_ff,
                                 cfg_factor=1, use_flash_kernel=feat >= 16)
    rngs = {"epi_slope": jax.random.key(1)}
    v = jm.init({"params": jax.random.key(4), **rngs}, jnp.asarray(x), jcond)
    want, _ = jm.apply(v, jnp.asarray(x), jcond, rngs=rngs)
    pm = port(pepi.EpiTransformer(C, heads=HEADS, norm_groups=8), v)
    pcond = pepi.EpiConditioning(F_mats=t(F_mats), video_length=Fw, F_mat_size=256,
                                 rand_slope_ff=rand_slope_ff, generator=torch.Generator())
    with torch.no_grad():
        got = pm(t(x), pcond)
    return got, want


@pytest.mark.parametrize("feat", [8, 16])
def test_epi_transformer_matches_jax(feat, monkeypatch):
    """feat 16 takes the fused-kernel route (K1, kv_index half swap) in
    both packages; feat 8 the gathered, materialized-bias route."""
    got, want = _epi_pair(feat, False, monkeypatch)
    close(got, want, f"epi feat {feat}")


def test_epi_transformer_rand_slope_ff_pinned(monkeypatch):
    """rand_slope_ff=True first-frame pseudo lines, slope pinned on both
    sides (as test_epi_module_golden_rand_slope_ff does)."""
    got, want = _epi_pair(16, True, monkeypatch, slope=0.7)
    close(got, want, "epi rand slope")


def test_epi_mono_direction_raises():
    from cvd_tpu_torch.models.epi import EpiConditioning, EpiTransformer

    m = EpiTransformer(32, heads=4, norm_groups=8)
    cond = EpiConditioning(F_mats=torch.zeros(4, 3, 3), video_length=2,
                           rand_slope_ff=False, mono_direction=True)
    with pytest.raises(NotImplementedError):
        m(torch.zeros(2, 2, 4, 4, 32), cond)


# ---------------------------------------------------------- initialization

def _created(**unet_overrides):
    import dataclasses

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules

    random_full = unet_overrides.pop("random_full", False)
    return PipelineModules.create(dataclasses.replace(SMOKE_UNET, **unet_overrides), SMOKE_VAE,
                                  SMOKE_CLIP, device="cpu", vae_encoder=True,
                                  generator=torch.Generator().manual_seed(0),
                                  random_full=random_full)


def _bundle_modules(m):
    return {"unet": m.unet, "vae": m.vae, "clip": m.clip, "pose": m.pose_encoder}


def test_default_init_untrained_epi_module_is_the_identity():
    """As in cvd_tpu (models/epi.py:383-386): proj_out starts at zero, so a
    freshly built epi module returns its input exactly."""
    from cvd_tpu_torch.models.epi import EpiConditioning

    m = _created()
    epi = m.unet.down_blocks[0].epi_modules[0]
    rng = np.random.default_rng(20)
    x = t(rng.standard_normal((2, 2, 8, 8, 32)).astype(np.float32))
    cond = EpiConditioning(F_mats=t((rng.standard_normal((4, 3, 3)) * 1e-3).astype(np.float32)),
                           video_length=2, rand_slope_ff=False)
    with torch.no_grad():
        assert torch.equal(epi(x, cond), x)
    inner = epi.epi_transformer
    assert inner.proj_in.weight.abs().max() > 0 and not inner.proj_out.weight.any()
    # the motion modules are not the identity by default, their pose merge is zero
    motion = m.unet.down_blocks[0].motion_modules[0].temporal_transformer
    assert motion.proj_out.weight.any()
    merge = motion.transformer_blocks[0].attention_blocks[0].processor.qkv_merge
    assert not merge.weight.any() and not merge.bias.any()


def test_default_init_norm_scales_are_one_and_biases_zero():
    from cvd_tpu_torch.models.layers import FusedGroupNorm

    norms = 0
    for name, mod in _bundle_modules(_created()).items():
        for sub in mod.modules():
            if isinstance(sub, (torch.nn.LayerNorm, torch.nn.GroupNorm, FusedGroupNorm)):
                norms += 1
                assert torch.all(sub.weight == 1) and not sub.bias.any(), name
        for n, p in mod.named_parameters():
            if n.endswith(".bias") or n == "bias":
                assert not p.any(), f"{name}.{n}"
            else:
                assert p.any() or n in getattr(mod, "zero_initialized", list)(), f"{name}.{n}"
    assert norms > 100


@pytest.mark.parametrize("motion_zero,epi_zero", [(False, True), (True, True), (True, False)])
def test_zero_initialize_flags_pick_the_zero_layers(motion_zero, epi_zero):
    unet = _created(motion_zero_initialize=motion_zero, epi_zero_initialize=epi_zero).unet
    params = dict(unet.named_parameters())
    motion = [n for n in params if n.endswith("temporal_transformer.proj_out.weight")]
    epi = [n for n in params if n.endswith("epi_transformer.proj_out.weight")]
    assert len(motion) == len(epi) == 20   # 2 a down block, 3 an up block
    assert all(bool(params[n].any()) != motion_zero for n in motion)
    assert all(bool(params[n].any()) != epi_zero for n in epi)
    zero = set(unet.zero_initialized())
    assert (set(motion) <= zero) == motion_zero and (set(epi) <= zero) == epi_zero
    assert sum(n.endswith("qkv_merge.weight") for n in zero) == 20


def test_random_full_still_draws_every_tensor():
    for name, mod in _bundle_modules(_created(random_full=True)).items():
        for n, p in mod.named_parameters():
            assert p.any() and p.min() < p.max(), f"{name}.{n}"
    from cvd_tpu_torch.pipelines.common import PipelineModules

    with pytest.raises(ValueError, match="generator"):
        PipelineModules.create(device="meta", random_full=True)


def test_the_pose_encoder_takes_its_own_channels_where_given():
    """``pose_encoder_kwargs`` may give the pose encoder narrower widths than
    the UNet's; without them it takes the UNet's."""
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules

    plucker = torch.randn(1, 2, 64, 64, 6, generator=torch.Generator().manual_seed(1))
    for kwargs, want in ((None, SMOKE_UNET.block_out_channels),
                         ({"channels": (16, 32, 32, 32)}, (16, 32, 32, 32))):
        m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                   generator=torch.Generator().manual_seed(0),
                                   pose_encoder_kwargs=kwargs)
        assert m.unet.config.block_out_channels == (32, 64, 64, 64)
        with torch.no_grad():
            feats = m.pose_encoder(plucker)
        assert tuple(f.shape[-1] for f in feats) == tuple(want)


# ---------------------------------------------------- pose, CLIP, VAE, DDIM

def test_pose_encoder_matches_jax():
    from cvd_tpu.models.pose_encoder import CameraPoseEncoder as JP
    from cvd_tpu_torch.models.pose_encoder import CameraPoseEncoder as PP

    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 64, 64, 6)).astype(np.float32)
    kw = dict(channels=(32, 64, 64, 64), temporal_attention_nhead=4)
    jm = JP(**kw)
    v = jm.init(jax.random.key(5), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    pm = port(PP(**kw), v)
    with torch.no_grad():
        got = pm(t(x))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, f"pose feature {i}")


def test_clip_matches_jax():
    from cvd_tpu.models.clip_text import CLIPTextConfig as JC, CLIPTextEncoder as JE
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig as PC, CLIPTextEncoder as PE

    kw = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
              intermediate_size=48)
    ids = np.random.default_rng(6).integers(0, 1000, (2, 77)).astype(np.int32)
    jm = JE(JC(**kw))
    v = jm.init(jax.random.key(6), jnp.asarray(ids))
    want = jm.apply(v, jnp.asarray(ids))
    pm = port(PE(PC(**kw)), v)
    with torch.no_grad():
        close(pm(t(ids)), want, "clip")


def test_vae_decoder_matches_jax():
    from cvd_tpu.models.vae import AutoencoderKL as JV, VAEConfig as JC
    from cvd_tpu_torch.models.vae import AutoencoderKL as PV, VAEConfig as PC

    kw = dict(block_out_channels=(32, 32, 64, 64), norm_num_groups=8)
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    jm = JV(JC(**kw))
    v = jm.init(jax.random.key(7), jnp.zeros((1, 32, 32, 3)), jax.random.key(0))
    want = jm.apply(v, jnp.asarray(z), method=jm.decode)
    sd = {k: w for k, w in state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v)).items()
          if k.startswith(("decoder.", "post_quant_conv."))}
    pm = PV(PC(**kw))
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        close(pm.decode(t(z)), want, "vae decode")


@pytest.mark.parametrize("steps", [2, 25])
def test_ddim_matches_jax(steps):
    from cvd_tpu.schedulers.ddim import DDIMScheduler as JD
    from cvd_tpu_torch.schedulers.ddim import DDIMScheduler as PD

    js, ps = JD().set_timesteps(steps), PD().set_timesteps(steps)
    np.testing.assert_array_equal(np.asarray(js.timesteps), ps.timesteps)
    np.testing.assert_array_equal(np.asarray(js.alphas_cumprod), ps.alphas_cumprod)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    eps = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for ts in ps.timesteps:
        want = JD().step(js, jnp.asarray(eps), jnp.asarray(ts), jnp.asarray(x))
        got = PD().step(ps, t(eps), int(ts), t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ state dicts

@pytest.fixture(scope="module")
def tiny_shapes():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE
    from cvd_tpu.pipelines.common import abstract_param_shapes

    return abstract_param_shapes(TINY_UNET, TINY_VAE, TINY_CLIP, latent_size=8,
                                 video_length=2)


@pytest.mark.parametrize("name", ["unet", "pose", "clip", "vae"])
def test_state_dict_keys_match_export_torch_state(name, tiny_shapes):
    """state_dict_from_flax gives exactly export_torch_state's keys and
    shapes, except that the four ``time_embedding.linear_{1,2}`` keys keep
    the SD1.5 checkpoint's names (export_torch_state writes ``linear.1``),
    and the port's module loads them with strict=True."""
    from cvd_tpu.io.key_mapping import export_torch_state
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from cvd_tpu_torch.models.pose_encoder import CameraPoseEncoder
    from cvd_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
    from cvd_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    shapes = tiny_shapes[name]
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = {k.replace("time_embedding.linear.", "time_embedding.linear_"): v
           for k, v in export_torch_state(tree).items()}
    sd = state_dict_from_flax(tree)
    assert set(sd) == set(ref)
    assert ("time_embedding.linear_1.weight" in sd) == (name == "unet")
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
    ch = (32, 64, 64, 64)
    module = {
        "unet": lambda: UNet3DConditionModel(UNetConfig(
            block_out_channels=ch, attention_heads=4, cross_attention_dim=24,
            norm_num_groups=8)),
        "pose": lambda: CameraPoseEncoder(channels=ch),
        "clip": lambda: CLIPTextEncoder(CLIPTextConfig(hidden_size=24, num_layers=2,
                                                       num_heads=4, intermediate_size=48)),
        "vae": lambda: AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 64, 64),
                                               norm_num_groups=8)),
    }[name]()
    if name == "vae":   # the port holds the decoder side only
        sd = {k: v for k, v in sd.items() if k.startswith(("decoder.", "post_quant_conv."))}
    module.load_state_dict(sd, strict=True)

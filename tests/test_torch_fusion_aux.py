"""First-frame fusion, the UNet's additional residuals and the auxiliary q/k
head of cvd_tpu_torch against cvd_tpu, on the CPU in f32.

The JAX UNets come from ``PipelineModules.create(..., fast_init=True)``:
every tensor is a fan-in-scaled uniform, so the layers that a fresh model
starts at zero (the fusion blocks' ``conv_out``, the epi ``proj_out``, the
pose merge) take part. Their params go to the port through
``state_dict_from_flax``. Same numpy inputs on both sides; horizontal
first-frame lines (``rand_slope_ff=False``). Tolerance: max |port - ref| <=
1e-5 * max(1, max |ref|) (f32 in both, summation order only).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvd_tpu_torch.io.from_flax import state_dict_from_flax

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(2)

TOL = 1e-5
Fr, S = 3, 8   # frames (two after the first, for the fusion), latent size


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = float(np.max(np.abs(got - want)))
    limit = TOL * max(1.0, float(np.max(np.abs(want))))
    assert err <= limit, f"{what}: max err {err:.3g} > {limit:.3g}"


def t(x):
    return torch.from_numpy(np.array(x))


FULL = dict(fuse_first_frame=True, additional_channel=4)


def unet_inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    return dict(
        sample=rng.standard_normal((B, Fr, S, S, 4)).astype(np.float32),
        timesteps=np.array([71, 642][:B]),
        text=rng.standard_normal((B, 7, 24)).astype(np.float32),
        pose=[rng.standard_normal((B, Fr, S >> i, S >> i, c)).astype(np.float32)
              for i, c in enumerate((32, 64, 64, 64))],
        F_mats=(rng.standard_normal((B * Fr, 3, 3)) * 1e-3).astype(np.float32))


def residuals(seed, B=2):
    """Residuals for the 12 states of the tiny UNet's down path and its mid block."""
    rng = np.random.default_rng(seed)
    shapes = [(32, S)] * 3 + [(32, S // 2)] + [(64, S // 2)] * 2 + [(64, S // 4)] \
        + [(64, S // 4)] * 2 + [(64, S // 8)] * 3
    down = [rng.standard_normal((B, Fr, s, s, c)).astype(np.float32) for c, s in shapes]
    return down, rng.standard_normal((B, Fr, S // 8, S // 8, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_full():
    """The tiny JAX UNet with first-frame fusion and the auxiliary head, its
    fast-init params and one jitted call (residuals always passed: zeros for
    a call without them, so one compile serves both)."""
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    from cvd_tpu.models.epi import EpiConditioning
    from cvd_tpu.models.unet import UNet3DConditionModel
    from cvd_tpu.pipelines.common import PipelineModules

    cfg = dataclasses.replace(TINY_UNET, **FULL)
    m = PipelineModules.create(unet_config=cfg, vae_config=TINY_VAE, clip_config=TINY_CLIP,
                               latent_size=S, video_length=Fr, fast_init=True)
    jm = UNet3DConditionModel(cfg)

    @jax.jit
    def call(params, x, down, mid):
        cond = EpiConditioning(F_mats=x["F_mats"], video_length=Fr, rand_slope_ff=False,
                               cfg_factor=1)
        out, extras = jm.apply(params, x["sample"], x["timesteps"], x["text"], x["pose"], cond,
                               down_block_additional_residuals=down,
                               mid_block_additional_residual=mid)
        return out, extras["auxiliary"], extras["epi_qk"][-1]

    return m.unet_params, call


def port_unet(params, **fields):
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.unet import UNet3DConditionModel

    unet = UNet3DConditionModel(dataclasses.replace(SMOKE_UNET, **fields))
    unet.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                         strict=True)
    return unet.eval()


# ------------------------------------------------------------- FusionBlock2D

def test_fusion_block_matches_jax():
    """A nonzero ``conv_out`` (a fresh one is zero: the block is then the
    identity and proves nothing); the GroupNorms over 2C and 3C channels."""
    from cvd_tpu.models.layers import FusionBlock2D as JF
    from cvd_tpu_torch.models.layers import FusionBlock2D as PF

    rng = np.random.default_rng(0)
    B, F1, H, C, Ct = 2, 3, 4, 32, 48
    first = rng.standard_normal((B, 1, H, H, C)).astype(np.float32)
    post = rng.standard_normal((B, F1, H, H, C)).astype(np.float32)
    temb = rng.standard_normal((B, Ct)).astype(np.float32)
    jm = JF(C, temb_channels=Ct)
    v = jm.init(jax.random.key(0), jnp.asarray(first), jnp.asarray(post), jnp.asarray(temb))
    params = jax.tree_util.tree_map(np.asarray, v)
    conv_out = params["params"]["conv_out"]
    conv_out["kernel"] = rng.standard_normal(conv_out["kernel"].shape).astype(np.float32) * 0.1
    conv_out["bias"] = rng.standard_normal(conv_out["bias"].shape).astype(np.float32) * 0.1
    want = jm.apply(params, jnp.asarray(first), jnp.asarray(post), jnp.asarray(temb))
    pm = PF(C, temb_channels=Ct)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = pm(t(first), t(post), t(temb))
    close(got, want, "FusionBlock2D")
    assert float(np.max(np.abs(np.asarray(want) - post))) > 0.1   # not the identity


def test_fresh_fusion_blocks_are_the_identity():
    """Under ``default_init_`` both fusers start as the identity (their
    ``conv_out`` is zero), as the reference's zero-initialized output conv."""
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.unet import UNet3DConditionModel
    from cvd_tpu_torch.pipelines.common import default_init_

    unet = UNet3DConditionModel(dataclasses.replace(SMOKE_UNET, fuse_first_frame=True))
    default_init_(unet, torch.Generator().manual_seed(0), unet.zero_initialized())
    assert {"down_fusers.0.conv_out.weight", "mid_fuser.conv_out.weight"} <= set(
        unet.zero_initialized())
    rng = np.random.default_rng(1)
    post = t(rng.standard_normal((2, 2, 4, 4, 32)).astype(np.float32))
    first = t(rng.standard_normal((2, 1, 4, 4, 32)).astype(np.float32))
    with torch.no_grad():
        out = unet.down_fusers[0](first, post, torch.randn(2, 128))
    assert torch.equal(out, post)


# ------------------------------------------------------------------- the UNet

@pytest.mark.parametrize("with_residuals", [False, True])
def test_unet_with_fusion_residuals_and_head_matches_jax(jax_full, with_residuals):
    """The tiny UNet with ``fuse_first_frame`` (both fusers, every tensor
    nonzero), ``additional_channel`` 4, and a SparseCtrl model's residuals on
    all 12 states of the down path and the mid block (zeros in the case
    without): the output, ``auxiliary`` [B, F, s, s, 8] and the last epi
    attention's query and gathered key maps."""
    from cvd_tpu_torch.models.epi import EpiConditioning

    params, call = jax_full
    x = unet_inputs(3)
    down, mid = residuals(4)
    if not with_residuals:
        down, mid = [np.zeros_like(r) for r in down], np.zeros_like(mid)
    want, want_aux, want_qk = call(params, jax.tree_util.tree_map(jnp.asarray, x),
                                   [jnp.asarray(r) for r in down], jnp.asarray(mid))
    unet = port_unet(params, **FULL)
    assert unet.conv_auxiliary_query.weight.shape == (4, 32, 1, 1)
    args = (t(x["sample"]), t(x["timesteps"]), t(x["text"]), [t(p) for p in x["pose"]],
            EpiConditioning(F_mats=t(x["F_mats"]), video_length=Fr, rand_slope_ff=False,
                            cfg_factor=1))
    kw = {}
    if with_residuals:
        kw = dict(down_block_additional_residuals=[t(r) for r in down],
                  mid_block_additional_residual=t(mid))
    with torch.no_grad():
        got, extras = unet(*args, return_extras=True, **kw)
        bare = unet(*args)
    close(got, want, "UNet output")
    close(extras["auxiliary"], want_aux, "auxiliary")
    assert extras["auxiliary"].shape == (2, Fr, S, S, 8)
    for name in ("query", "key"):
        close(extras["epi_qk"][-1][name], want_qk[name], f"last epi {name}")
    assert len(extras["epi_qk"]) == 2   # the last epi module's two attentions
    # the residuals change the output; without them the call is the plain one
    assert (float((bare - got).abs().max()) > 1e-2) == with_residuals


def test_unet_without_extras_returns_the_output_alone():
    """The sampler's call sites are unchanged: no ``return_extras``, one
    tensor, the same as the first value with it; no head: ``auxiliary`` None."""
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.models.unet import UNet3DConditionModel
    from cvd_tpu_torch.pipelines.common import random_init_

    unet = random_init_(UNet3DConditionModel(SMOKE_UNET), torch.Generator().manual_seed(2))
    x = unet_inputs(4)
    args = (t(x["sample"]), t(x["timesteps"]), t(x["text"]), [t(p) for p in x["pose"]],
            EpiConditioning(F_mats=t(x["F_mats"]), video_length=Fr, rand_slope_ff=False))
    with torch.no_grad():
        out = unet(*args)
        out2, extras = unet(*args, return_extras=True)
    assert isinstance(out, torch.Tensor) and torch.equal(out, out2)
    assert extras["auxiliary"] is None and len(extras["epi_qk"]) == 2


@pytest.mark.parametrize("feat", [8, 16])
def test_epi_attention_maps_match_jax(feat, monkeypatch):
    """The q/k maps an epi transformer hands the head: feat 16 takes the
    kernel route (K1, the key rows gathered by the half-swap route after the
    call), feat 8 the gathered route; against the JAX module's aux output."""
    from cvd_tpu.models import epi as jepi
    from cvd_tpu_torch.models import epi as pepi

    B, Fw, C, HEADS = 2, 2, 32, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, Fw, feat, feat, C)).astype(np.float32)
    F_mats = (rng.standard_normal((B * Fw, 3, 3)) * 1e-3).astype(np.float32)
    jm = jepi.EpiTransformer(in_channels=C, heads=HEADS, norm_groups=8, zero_initialize=False)
    jcond = jepi.EpiConditioning(F_mats=jnp.asarray(F_mats), video_length=Fw, F_mat_size=256,
                                 rand_slope_ff=False, cfg_factor=1,
                                 use_flash_kernel=feat >= 16)
    v = jm.init(jax.random.key(4), jnp.asarray(x), jcond)
    want, jaux = jm.apply(v, jnp.asarray(x), jcond)
    pm = pepi.EpiTransformer(C, heads=HEADS, norm_groups=8)
    pm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v)), strict=True)
    pcond = pepi.EpiConditioning(F_mats=t(F_mats), video_length=Fw, F_mat_size=256,
                                 rand_slope_ff=False)
    qk = []
    with torch.no_grad():
        got = pm(t(x), pcond, qk=qk)
        alone = pm(t(x), pcond)
    assert torch.equal(got, alone)
    close(got, want, f"epi out feat {feat}")
    assert len(qk) == len(jaux) == 2
    for mine, theirs in zip(qk, jaux):
        for name in ("query", "key"):
            close(mine[name], theirs[name], f"epi {name} feat {feat}")


def test_pab_reuse_gives_zero_maps():
    """On a PAB reuse the attention does not run: its maps are zeros, as in
    the JAX package (epi.py:153-168)."""
    from cvd_tpu_torch.models import epi as pepi

    class Reuse:
        def run(self, site, kind, fn):
            return torch.ones(1)

    pm = pepi.EpiTransformer(32, heads=4, norm_groups=8)
    qk = []
    x = torch.randn(2, 2, 4, 4, 32)
    with torch.no_grad():
        pm(x, pepi.EpiConditioning(F_mats=torch.zeros(4, 3, 3), video_length=2,
                                   rand_slope_ff=False), pab=Reuse(), qk=qk)
    assert len(qk) == 2 and all(not m["query"].any() and not m["key"].any() for m in qk)
    assert qk[0]["query"].shape == (4, 16, 32)

"""``cvd_tpu_torch.schedulers.inversion`` against
``cvd_tpu.schedulers.inversion`` on the same latents (a seed, numpy): with
a fixed ``eps_fn`` and with the tiny UNet (cvd_tpu's weights through
``from_flax``) as ``eps_fn``, the final latents and the trajectory agree to
1e-5 x max|ref| (f32); the first step's timestep is negative and reaches
``eps_fn`` as 0; and the round trip of tests/test_extras.py (invert, then
denoise with the same eps) returns to x0."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from cvd_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM  # noqa: E402
from cvd_tpu.schedulers.inversion import ddim_invert as jax_invert  # noqa: E402
from cvd_tpu_torch.schedulers.ddim import DDIMScheduler  # noqa: E402
from cvd_tpu_torch.schedulers.inversion import ddim_invert, ddim_inversion_step  # noqa: E402

torch.set_num_threads(2)
REL_TOL = 1e-5


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("steps", [5, 25])
def test_fixed_eps_matches_jax(steps):
    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    seen = []

    def eps_fn(lat, t):
        seen.append(t)
        return torch.from_numpy(eps) * (1 + t / 1000)

    got, traj = ddim_invert(eps_fn, DDIMScheduler(), DDIMScheduler().set_timesteps(steps),
                            torch.from_numpy(x0))
    want, want_traj = jax_invert(lambda lat, t: jnp.asarray(eps) * (1 + t / 1000), JaxDDIM(),
                                 JaxDDIM().set_timesteps(steps), jnp.asarray(x0))
    assert traj.shape == (steps,) + x0.shape
    close(got, want)
    close(traj, want_traj)
    stride = 1000 // steps
    assert seen[0] == 0 and seen[1:] == list(DDIMScheduler().set_timesteps(steps).timesteps[::-1]
                                             [1:] - stride)


def test_the_first_step_takes_the_final_alpha():
    """t < 0: alpha_t is the final alpha (1), so x0 = sample and the step
    lands on sqrt(a_next) x + sqrt(1 - a_next) eps."""
    sched = DDIMScheduler()
    state = sched.set_timesteps(10)
    x, eps = torch.randn(4), torch.randn(4)
    a = float(state.alphas_cumprod[1])
    got = ddim_inversion_step(sched, state, eps, 1 - 100, x)
    torch.testing.assert_close(got, a ** 0.5 * x + (1 - a) ** 0.5 * eps)


def test_roundtrip_returns_to_x0():
    sched = DDIMScheduler()
    st = sched.set_timesteps(25)
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((1, 4, 4)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((1, 4, 4)).astype(np.float32))
    noisy, traj = ddim_invert(lambda lat, t: eps, sched, st, x0)
    assert traj.shape[0] == 25
    back = noisy
    for t in st.timesteps:
        back = sched.step(st, eps, t, back)
    np.testing.assert_allclose(back.numpy(), x0.numpy(), atol=2e-3)


def test_unet_eps_matches_jax():
    """The tiny UNet (cvd_tpu's fast-init weights in both packages) as the
    noise model of a 3-step inversion: final latents and trajectory."""
    from cvd_tpu.models.epi import EpiConditioning as JaxCond
    from cvd_tpu.pipelines.common import PipelineModules as JaxModules
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.models.unet import UNet3DConditionModel

    Fr, S = 2, 8
    jm = JaxModules.create(unet_config=TINY_UNET, vae_config=TINY_VAE, clip_config=TINY_CLIP,
                           latent_size=S, video_length=Fr, fast_init=True)
    unet = UNet3DConditionModel(SMOKE_UNET)
    unet.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                     jm.unet_params)))
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, TINY_UNET.cross_attention_dim)).astype(np.float32)
    F_mats = (rng.standard_normal((2 * Fr, 3, 3)) * 1e-3).astype(np.float32)
    pose = [rng.standard_normal((2, Fr, S >> i, S >> i, c)).astype(np.float32)
            for i, c in enumerate(TINY_UNET.block_out_channels)]

    def eps_fn(lat, t):
        cond = EpiConditioning(F_mats=torch.from_numpy(F_mats), video_length=Fr,
                               rand_slope_ff=False)
        with torch.no_grad():
            return unet(lat, t, torch.from_numpy(ctx), [torch.from_numpy(p) for p in pose], cond)

    def jax_eps(lat, t):
        cond = JaxCond(F_mats=jnp.asarray(F_mats), video_length=Fr, rand_slope_ff=False,
                       use_flash_kernel=False)
        out, _ = jm.unet.apply(jm.unet_params, lat, t, jnp.asarray(ctx),
                               [jnp.asarray(p) for p in pose], cond)   # (out, aux)
        return out

    got, traj = ddim_invert(eps_fn, DDIMScheduler(), DDIMScheduler().set_timesteps(3),
                            torch.from_numpy(x0))
    want, want_traj = jax_invert(jax_eps, JaxDDIM(), JaxDDIM().set_timesteps(3),
                                 jnp.asarray(x0))
    close(got, want)
    close(traj, want_traj)

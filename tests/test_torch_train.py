"""The training slice: cvd_tpu_torch.train against cvd_tpu.train.

One train step runs on both sides from the same weights (the JAX tiny
bundle, every parameter perturbed so the zero-initialized epi and
pose-merge layers take part, converted with state_dict_from_flax), the same
batch, and the noise and timesteps that JAX's step draws from its rng
(pinned on the port's side); first-frame pseudo lines are horizontal
(rand_slope_ff=False). JAX's gradients come from a TrainState with
optax.sgd(1.0), so params - new params = grads. Bars: loss to 1e-5
relative, trainable gradients at >= 60 dB SNR.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(2)

Fr, S = 2, 8  # frames, latent size


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
        tree)


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "latents": rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32),
        "text_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32),
        "plucker": rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32),
        "F_mats": (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32),
    }


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_bundle():
    from tiny import tiny_modules

    base = tiny_modules(latent_size=S, video_length=Fr)
    params = _perturbed(base.unet_params, 0)
    return dataclasses.replace(base, unet_params=jax.tree_util.tree_map(jnp.asarray, params),
                               pose_encoder_params=_perturbed(base.pose_encoder_params, 1))


@pytest.fixture(scope="module")
def jax_step(jax_bundle):
    """One jitted cvd_tpu train step (XLA path, remat off): its loss, its
    gradients and the noise / timesteps it drew."""
    import optax

    from cvd_tpu.train.state import TrainState
    from cvd_tpu.train.train_step import train_step

    jm = jax_bundle
    tx = optax.sgd(1.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jm.unet_params,
                       opt_state=tx.init(jm.unet_params), tx=tx)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.key(7)
    new_state, metrics = jax.jit(lambda s, b, k: train_step(
        s, b, jm, k, rand_slope_ff=False, use_flash_kernel=False, remat=False))(state, batch, key)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   jm.unet_params, new_state.params)
    _, eps_key, t_key, _, _ = jax.random.split(key, 5)
    noise = np.asarray(jax.random.normal(eps_key, (2, Fr, S, S, 4), jnp.float32))
    timesteps = np.asarray(jax.random.randint(t_key, (2,), 0, 1000))
    return float(metrics["loss"]), grads, noise, timesteps


def _port_modules(jm):
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.pipelines.common import PipelineModules

    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu")
    m.unet.load_state_dict(state_dict_from_flax(jm.unet_params), strict=True)
    m.pose_encoder.load_state_dict(state_dict_from_flax(jm.pose_encoder_params), strict=True)
    m.clip.load_state_dict(state_dict_from_flax(jm.clip_params), strict=True)
    return m


def test_train_step_loss_and_grads_match_jax(jax_bundle, jax_step):
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    want_loss, want_grads, noise, timesteps = jax_step
    m = _port_modules(jax_bundle)
    state = create_train_state(m.unet)
    loss, _ = loss_and_grads(state, _torch_batch(_batch()), m, noise=torch.from_numpy(noise),
                             timesteps=torch.from_numpy(timesteps), F_mat_size=256,
                             rand_slope_ff=False, remat=True)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    want = state_dict_from_flax(want_grads)
    params = dict(m.unet.named_parameters())
    assert len(state.trainable) > 50
    got = np.concatenate([params[n].grad.numpy().ravel() for n in state.trainable])
    ref = np.concatenate([want[n].numpy().ravel() for n in state.trainable])
    assert _snr_db(got, ref) >= 60.0, f"gradient SNR {_snr_db(got, ref):.1f} dB"
    # every trainable tensor gets a gradient, nonzero wherever JAX's is:
    # only to_q/to_k on the 1x1 grids are zero on both sides (a softmax over
    # one key does not depend on q or k)
    zero = {n for n in state.trainable if not params[n].grad.any()}
    assert zero == {n for n in state.trainable if not want[n].any()}
    assert all(n.endswith(("to_q.weight", "to_k.weight")) for n in zero), zero
    frozen = [p for n, p in params.items() if n not in set(state.trainable)]
    assert frozen and all(p.grad is None and not p.requires_grad for p in frozen)
    # cvd_tpu's stop_gradient mask: its frozen leaves got no update either
    assert all(not want[n].any() for n in params if n not in set(state.trainable))


def test_trainable_set_matches_jax_mask(jax_bundle):
    from flax import traverse_util

    from cvd_tpu.io.key_mapping import flax_path_to_torch_key
    from cvd_tpu.train.state import trainable_mask as jax_mask
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.unet import UNet3DConditionModel
    from cvd_tpu_torch.train.state import trainable_mask

    flat = traverse_util.flatten_dict(jax_mask(jax_bundle.unet_params)["params"])
    # the export writes time_embedding.linear_1 as linear.1; the checkpoint's
    # name, which the port has, keeps the underscore
    want = {flax_path_to_torch_key(k).replace("time_embedding.linear.", "time_embedding.linear_"): v
            for k, v in flat.items()}
    with torch.device("meta"):
        unet = UNet3DConditionModel(SMOKE_UNET)
    got = trainable_mask([n for n, _ in unet.named_parameters()])
    assert got == want
    assert sum(got.values()) > 50


def test_frozen_bf16_step_updates_only_trainable_masters():
    """bf16 frozen weights, f32 trainable masters: one step leaves every
    frozen tensor bit-identical (and gradient-free) and moves the masters."""
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import train_step

    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    state = create_train_state(m.unet, learning_rate=1e-3, frozen_dtype=torch.bfloat16)
    trainable = set(state.trainable)
    before = {n: p.detach().clone() for n, p in m.unet.named_parameters()}
    for n, p in m.unet.named_parameters():
        assert p.dtype == (torch.float32 if n in trainable else torch.bfloat16), n
    out = train_step(state, _torch_batch(_batch()), m, torch.Generator().manual_seed(1),
                     remat=False)
    assert np.isfinite(out["loss"]) and state.step == 1
    for n, p in m.unet.named_parameters():
        if n in trainable:
            assert p.dtype == torch.float32
        else:
            assert p.grad is None and torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n]) for n, p in m.unet.named_parameters()
               if n in trainable)


def test_remat_gives_the_same_gradients():
    """Block remat replays each block in the backward; with a random
    first-frame slope (drawn once per step) the gradients do not change."""
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    state = create_train_state(m.unet)
    grads, losses = [], []
    for remat in (False, True):
        losses.append(float(loss_and_grads(state, _torch_batch(_batch(3)), m,
                                           torch.Generator().manual_seed(5),
                                           rand_slope_ff=True, remat=remat)[0]))
        grads.append([p.grad.clone() for p in state.trainable_params()])
        state.optimizer.zero_grad(set_to_none=True)
    assert losses[0] == losses[1]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_optimizer_matches_optax_chain(schedule):
    """AdamW + global-norm clipping over the trainable set + the LR
    schedule with warmup, against create_train_state's optax chain, over 5
    steps on fixed gradients (optax counts from 0: step 1 has lr 0)."""
    from cvd_tpu.train.state import create_train_state as jax_create
    from cvd_tpu_torch.train.state import create_train_state

    rng = np.random.default_rng(8)
    toy = nn.Module()
    toy.epi_modules = nn.Linear(4, 3)
    toy.frozen = nn.Linear(4, 3)
    with torch.no_grad():
        for p in toy.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    names = [n for n, _ in toy.named_parameters()]
    tree = {}
    for n, p in toy.named_parameters():
        mod, leaf = n.split(".")
        tree.setdefault(mod, {})[leaf] = jnp.asarray(p.detach().numpy())
    kw = dict(learning_rate=1e-2, adam_weight_decay=1e-2, max_grad_norm=0.5,
              scheduler=schedule, warmup_steps=2, total_steps=5)
    jstate = jax_create(tree, **kw)
    state = create_train_state(toy, **kw)
    assert state.trainable == ["epi_modules.weight", "epi_modules.bias"]
    params = dict(toy.named_parameters())
    for step in range(5):
        g = {n: rng.standard_normal(tuple(params[n].shape)).astype(np.float32) for n in names}
        jstate = jstate.apply_gradients(
            {mod: {leaf: jnp.asarray(g[f"{mod}.{leaf}"]) for leaf in v} for mod, v in tree.items()})
        for n in state.trainable:
            params[n].grad = torch.from_numpy(g[n])
        state.apply_gradients()
        for n in names:
            mod, leaf = n.split(".")
            np.testing.assert_allclose(params[n].detach().numpy(),
                                       np.asarray(jstate.params[mod][leaf]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {step + 1} {n}")
    assert state.step == 5


def test_masked_mse_and_epi_distance_loss_match_jax():
    from cvd_tpu.train.losses import epi_distance_loss as jax_epi_loss
    from cvd_tpu.train.losses import masked_mse_loss as jax_mse
    from cvd_tpu_torch.train.losses import epi_distance_loss, masked_mse_loss

    rng = np.random.default_rng(9)
    pred, tgt = (rng.standard_normal((2, 2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    mask = (rng.random((2, 2, 4, 4, 1)) > 0.4).astype(np.float32)
    for mk in (None, mask):
        want = float(jax_mse(jnp.asarray(pred), jnp.asarray(tgt),
                             None if mk is None else jnp.asarray(mk)))
        got = float(masked_mse_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                                    None if mk is None else torch.from_numpy(mk)))
        assert got == pytest.approx(want, rel=1e-6)
    aux = rng.standard_normal((1, 2, 8, 8, 32)).astype(np.float32)
    F_mats = (rng.standard_normal((2, 3, 3)) * 1e-2).astype(np.float32)
    want = float(jax_epi_loss(jnp.asarray(aux), jnp.asarray(F_mats), 256))
    got = float(epi_distance_loss(torch.from_numpy(aux), torch.from_numpy(F_mats), 256))
    assert got == pytest.approx(want, rel=1e-5)


def test_add_noise_matches_jax():
    from cvd_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
    from cvd_tpu_torch.schedulers import DDIMScheduler

    rng = np.random.default_rng(10)
    x0, eps = (rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ts = np.array([0, 517, 999])
    js = JaxDDIM()
    want = js.add_noise(js.set_timesteps(50), jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(ts))
    ps = DDIMScheduler()
    got = ps.add_noise(ps.set_timesteps(50), torch.from_numpy(x0), torch.from_numpy(eps),
                       torch.from_numpy(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_vae_encoder_moments_match_jax():
    """The whole VAE (encoder, quant_conv, decoder) loads the converted JAX
    tree with strict=True; encode's (mean, logvar) match AutoencoderKL.encode."""
    from cvd_tpu.models.vae import AutoencoderKL as JaxVAE
    from tiny import TINY_VAE

    from cvd_tpu_torch.cli.build import SMOKE_VAE
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.models.vae import AutoencoderKL

    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jvae = JaxVAE(TINY_VAE)
    params = _perturbed(jvae.init(jax.random.key(0), jnp.asarray(x), jax.random.key(1)), 2)
    want = jvae.apply(params, jnp.asarray(x), method=jvae.encode)
    vae = AutoencoderKL(SMOKE_VAE, with_encoder=True)
    vae.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(x))
    for gi, wi in zip(got, want):
        wi = np.asarray(wi)
        assert gi.shape == wi.shape == (2, 4, 4, 4)
        np.testing.assert_allclose(gi.numpy(), wi, rtol=0, atol=1e-4 * np.abs(wi).max())

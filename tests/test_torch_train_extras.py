"""The training options of cvd_tpu_torch that this slice ports, against
cvd_tpu on the CPU in f32: the auxiliary q/k head's epipolar loss, the
latents cache and validation sampling.

The JAX bundle is ``PipelineModules.create(..., fast_init=True)`` with
``additional_channel`` 4 (every tensor a fan-in-scaled uniform, the head
included), converted with ``state_dict_from_flax``. The training step runs
from the cache's batch keys with a tight posterior (logvar -1e9, cvd_tpu's
``test_train_step_latent_moments_batch`` setup), the noise and timesteps
pinned to what JAX's step draws, horizontal first-frame lines. JAX's
gradients come out exactly through an optimizer that keeps them as its state
(params - new params would round the head's 1e-7 gradients). Bars: loss and
``epi_loss`` to 1e-5 relative, trainable gradients at >= 60 dB SNR.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
Fr, S = 2, 16  # frames, latent size: the last epi layer at 16 x 16 takes the kernel route
AUX = 4
LAST_EPI = "up_blocks.3.epi_modules.2.epi_transformer.transformer_blocks.0.attention_blocks.1"


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    return {
        "latent_mean": latents / np.float32(0.18215),
        "latent_logvar": np.full(latents.shape, -1e9, np.float32),
        "text_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32),
        "plucker": rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32),
        "F_mats": (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32),
    }


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_bundle():
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    from cvd_tpu.pipelines.common import PipelineModules

    return PipelineModules.create(
        unet_config=dataclasses.replace(TINY_UNET, additional_channel=AUX),
        vae_config=TINY_VAE, clip_config=TINY_CLIP, latent_size=S, video_length=Fr,
        fast_init=True)


@pytest.fixture(scope="module")
def jax_steps(jax_bundle):
    """cvd_tpu's train step at epi_loss_weight 0.002 and 1.0 (one compile: the
    weight is an argument): {weight: (loss, epi_loss, gradients)}, and the
    noise / timesteps it drew."""
    import optax

    from cvd_tpu.train.state import TrainState
    from cvd_tpu.train.train_step import train_step

    jm = jax_bundle
    # the update is zero and the new optimizer state is the gradient itself
    tx = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    key = jax.random.key(7)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    step = jax.jit(lambda s, b, k, w: train_step(s, b, jm, k, rand_slope_ff=False,
                                                 use_flash_kernel=False, remat=False,
                                                 epi_loss_weight=w))
    out = {}
    for weight in (0.002, 1.0):
        state = TrainState(step=jnp.zeros((), jnp.int32), params=jm.unet_params,
                           opt_state=tx.init(jm.unet_params), tx=tx)
        new_state, metrics = step(state, batch, key, jnp.float32(weight))
        grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state)
        out[weight] = (float(metrics["loss"]), float(metrics["epi_loss"]), grads)
    _, eps_key, t_key, _, _ = jax.random.split(key, 5)
    noise = np.asarray(jax.random.normal(eps_key, (2, Fr, S, S, 4), jnp.float32))
    timesteps = np.asarray(jax.random.randint(t_key, (2,), 0, 1000))
    return out, noise, timesteps


def _port_modules(jm):
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules

    m = PipelineModules.create(dataclasses.replace(SMOKE_UNET, additional_channel=AUX),
                               SMOKE_VAE, SMOKE_CLIP, device="cpu", vae_encoder=True)
    m.unet.load_state_dict(state_dict_from_flax(jm.unet_params), strict=True)
    m.pose_encoder.load_state_dict(state_dict_from_flax(jm.pose_encoder_params), strict=True)
    m.clip.load_state_dict(state_dict_from_flax(jm.clip_params), strict=True)
    m.vae.load_state_dict(state_dict_from_flax(jm.vae_params), strict=True)
    return m


# ------------------------------------------------------ the auxiliary q/k head

@pytest.mark.parametrize("weight", [0.002, 1.0])
def test_train_step_with_the_auxiliary_head_matches_jax(jax_bundle, jax_steps, weight):
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    ref, noise, timesteps = jax_steps
    want_loss, want_epi, want_grads = ref[weight]
    m = _port_modules(jax_bundle)
    state = create_train_state(m.unet)
    loss, epi = loss_and_grads(state, _torch_batch(_batch()), m, noise=torch.from_numpy(noise),
                                 timesteps=torch.from_numpy(timesteps), F_mat_size=256,
                                 rand_slope_ff=False, remat=True, epi_loss_weight=weight)
    assert want_epi > 0 and abs(float(epi) - want_epi) <= 1e-5 * want_epi
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    want = state_dict_from_flax(want_grads)
    params = dict(m.unet.named_parameters())
    head = ["conv_auxiliary_query.weight", "conv_auxiliary_query.bias",
            "conv_auxiliary_key.weight", f"{LAST_EPI}.to_q.weight", f"{LAST_EPI}.to_k.weight"]
    assert set(head) | {"conv_auxiliary_key.bias"} <= set(state.trainable)
    for names in [state.trainable] + [[n] for n in head]:
        got = np.concatenate([params[n].grad.numpy().ravel() for n in names])
        ref_g = np.concatenate([want[n].numpy().ravel() for n in names])
        assert np.any(ref_g) and _snr_db(got, ref_g) >= 60.0, \
            f"{names[0] if len(names) == 1 else 'trainable'}: {_snr_db(got, ref_g):.1f} dB"
    # a bias on every key adds one constant to a query's logits, which the
    # softmax ignores: that gradient is 0 on both sides, up to rounding
    scale = float(np.abs(want["conv_auxiliary_key.weight"].numpy()).max())
    for g in (params["conv_auxiliary_key.bias"].grad.numpy(),
              want["conv_auxiliary_key.bias"].numpy()):
        assert np.abs(g).max() <= 1e-4 * scale


def test_epi_loss_weight_weighs_the_head(jax_steps):
    """The head's loss enters with its weight (cvd_tpu's numbers)."""
    ref = jax_steps[0]
    (l1, e1, _), (l2, e2, _) = ref[0.002], ref[1.0]
    assert e1 == pytest.approx(e2, rel=1e-6)
    assert (l2 - l1) == pytest.approx((1.0 - 0.002) * e1, rel=1e-4)


def test_auxiliary_step_remat_on_equals_off(jax_bundle):
    """Block remat replays each block in the backward, the q/k maps among
    the last epi block's outputs: equal losses and gradients."""
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    m = _port_modules(jax_bundle)
    state = create_train_state(m.unet)
    out = []
    for remat in (False, True):
        loss, epi = loss_and_grads(state, _torch_batch(_batch(3)), m,
                                     torch.Generator().manual_seed(5), rand_slope_ff=True,
                                     remat=remat, epi_loss_weight=1.0)
        out.append((float(loss), float(epi), [p.grad.clone() for p in state.trainable_params()]))
        state.optimizer.zero_grad(set_to_none=True)
    (l0, e0, g0), (l1, e1, g1) = out
    assert l0 == l1 and e0 == e1 and e0 > 0
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_cache_batch_with_a_tight_posterior_is_the_latents_batch(jax_bundle):
    """A cached item's moments with logvar -1e9 give the step of its latents
    (cvd_tpu's test_train_step_latent_moments_batch): same loss."""
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    m = _port_modules(jax_bundle)
    b = _batch(4)
    plain = dict(b, latents=b["latent_mean"] * np.float32(0.18215))
    del plain["latent_mean"], plain["latent_logvar"]
    losses = []
    for batch in (b, plain):
        state = create_train_state(m.unet)
        rng = np.random.default_rng(9)
        losses.append(float(loss_and_grads(
            state, _torch_batch(batch), m, torch.Generator().manual_seed(1),
            noise=torch.from_numpy(rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)),
            timesteps=torch.tensor([10, 900]), rand_slope_ff=False)[0]))
        state.optimizer.zero_grad(set_to_none=True)
    assert np.isfinite(losses[0]) and losses[0] == pytest.approx(losses[1], rel=1e-6)


# ------------------------------------------------------------- latents cache

class _Pairs:
    """In-memory folded pairs with RealEstate10KPoseFolded's sample keys: the
    cameras of assets/pose_files, seeded pixels."""

    def __init__(self, n_items=2, n_frames=2, size=64):
        from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded

        cams = ValRealEstate10KPoseFolded(
            ["a quiet living room"], os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
            os.path.join(ASSETS, "pose_files", "example_arc.txt"),
            sample_n_frames=n_frames, sample_size=size)[0]
        self.cams = {k: cams[k].astype(np.float32)
                     for k in ("plucker_embedding", "F_mats", "ret_c2w", "ret_K_mats")}
        self.n_items, self.shape = n_items, (2 * n_frames, size, size, 3)

    def __len__(self):
        return self.n_items

    def __getitem__(self, i):
        rng = np.random.default_rng(int(i))
        return {"pixel_values": rng.uniform(-1, 1, self.shape).astype(np.float32),
                "text": f"a quiet living room {i}", **self.cams}


def test_encode_moments_match_jax(jax_bundle):
    """``make_encode_fn`` (chunks of 8 frames) against cvd_tpu's on the same
    VAE weights, 10 frames: 1e-5 * max(1, max |ref|)."""
    from cvd_tpu.data.latents_cache import make_encode_fn as jax_encode
    from cvd_tpu_torch.data.latents_cache import make_encode_fn

    m = _port_modules(jax_bundle)
    images = np.random.default_rng(3).uniform(-1, 1, (10, 64, 64, 3)).astype(np.float32)
    want = jax_encode(jax_bundle)(jax_bundle.vae_params, jnp.asarray(images))
    got = make_encode_fn(m)(images)
    for g, w, name in zip(got, want, ("mean", "logvar")):
        w = np.asarray(w)
        assert g.shape == w.shape == (10, 8, 8, 4)
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= 1e-5 * max(1.0, float(np.max(np.abs(w)))), f"{name}: {err:.3g}"


def test_a_cache_written_by_either_package_is_read_by_the_other(jax_bundle, tmp_path):
    """The same items, encoded by each package into its own cache: each
    cache read by both readers gives the same items (moments, text, F mats,
    poses and the Plücker maps derived from them); the two caches' moments
    agree to float16 rounding and their manifests are equal."""
    from cvd_tpu.data.latents_cache import CachedLatentsDataset as JaxCached
    from cvd_tpu.data.latents_cache import build_latents_cache as jax_build
    from cvd_tpu_torch.data.latents_cache import CachedLatentsDataset, build_latents_cache

    data = _Pairs()
    jax_build(data, jax_bundle, str(tmp_path / "jax"), num_items=2, log=lambda *_: None)
    report = build_latents_cache(data, _port_modules(jax_bundle), str(tmp_path / "port"),
                                 log=lambda *_: None)
    assert report["items"] == 2
    for root in ("jax", "port"):
        mine, theirs = CachedLatentsDataset(str(tmp_path / root)), JaxCached(str(tmp_path / root))
        assert len(mine) == len(theirs) == 2 and mine.meta == theirs.meta
        for i in range(2):
            a, b = mine[i], theirs[i]
            assert set(a) == set(b) and a["text"] == b["text"] == f"a quiet living room {i}"
            for k in ("latent_mean", "latent_logvar", "F_mats", "ret_c2w", "ret_K_mats"):
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
            np.testing.assert_allclose(a["plucker_embedding"], np.asarray(b["plucker_embedding"]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(a["plucker_embedding"], data.cams["plucker_embedding"],
                                       rtol=0, atol=1e-5)
    ports, jaxs = CachedLatentsDataset(str(tmp_path / "port")), JaxCached(str(tmp_path / "jax"))
    for i in range(2):
        for k in ("latent_mean", "latent_logvar"):
            a, b = ports[i][k], jaxs[i][k]
            assert np.max(np.abs(a - b)) <= 2 ** -10 * max(1.0, float(np.max(np.abs(b)))), k


def test_train_run_builds_the_cache_once(tmp_path):
    """``cache_latents``: the first run encodes ``latents_cache_items`` items
    into ``latents_cache_dir`` and trains from their moments (no sanity dump:
    no pixels); a second run reuses the cache."""
    from cvd_tpu_torch.cli import train

    cdir = tmp_path / "cache"
    cfg = dict(random_weights=True, device="cpu", sample_size=64, sample_n_frames=2,
               max_train_steps=2, checkpointing_steps=10, num_workers=1, logger_interval=1,
               cache_latents=True, latents_cache_dir=str(cdir), latents_cache_items=1,
               output_dir=str(tmp_path / "run"))
    out = train.run(cfg, sources=[_Pairs(n_items=3)])
    assert out["latents_cache"]["built"] and out["latents_cache"]["items"] == 1
    assert sorted(os.listdir(cdir)) == ["item-000000.npz", "manifest.json"]
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 2
    assert out["epi_losses"] == [0.0, 0.0]    # no head: the loss weighs nothing
    again = train.run(dict(cfg, output_dir=str(tmp_path / "run2")), sources=[_Pairs(n_items=3)])
    assert not again["latents_cache"]["built"] and again["latents_cache"]["items"] == 0


# --------------------------------------------------------- validation sampling

def _val_cfg(tmp_path, name, **kw):
    cfg = dict(random_weights=True, device="cpu", sample_size=64, sample_n_frames=2,
               max_train_steps=2, checkpointing_steps=10, num_workers=1, logger_interval=1,
               global_seed=5, do_sanity_check=False, output_dir=str(tmp_path / name),
               validation_data=dict(
                   pose_file_0=os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
                   pose_file_1=os.path.join(ASSETS, "pose_files", "example_arc.txt"),
                   prompts=["a scenic video"]),
               validation_steps_num=2)
    cfg.update(kw)
    return cfg


def test_validation_writes_the_live_weights_videos(tmp_path):
    """``validation_steps: 1`` with one step: ``validation/step-1.npy`` (and,
    where imageio is installed, the gif and the epipolar overlay) holds the
    videos a ``SimplePipeline`` makes with the weights of that step."""
    from cvd_tpu_torch.cli import train
    from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded
    from cvd_tpu_torch.pipelines.simple import SimplePipeline
    from cvd_tpu_torch.utils.video import have_imageio, to_uint8

    cfg = _val_cfg(tmp_path, "val", validation_steps=1, max_train_steps=1)
    out = train.run(cfg, sources=[_Pairs()])
    vdir = tmp_path / "val" / "validation"
    pictures = {"step-1.gif", "step-1-epi.png"} if have_imageio() else set()
    assert set(os.listdir(vdir)) == {"step-1.npy"} | pictures
    sample = ValRealEstate10KPoseFolded(["a scenic video"], **{
        k: cfg["validation_data"][k] for k in ("pose_file_0", "pose_file_1")},
        sample_n_frames=2, sample_size=64)[0]
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    tok = HashTokenizer()
    vids = SimplePipeline(out["modules"], F_mat_size=64)(
        torch.from_numpy(tok(["a scenic video"])), torch.from_numpy(tok([""])),
        torch.from_numpy(sample["plucker_embedding"]).float().reshape(2, 2, 64, 64, 6),
        torch.from_numpy(sample["F_mats"]).float().reshape(2, 2, 3, 3),
        num_inference_steps=2, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(np.load(vdir / "step-1.npy"), to_uint8(vids.numpy()))


def test_validation_leaves_the_training_losses_bit_identical(tmp_path):
    from cvd_tpu_torch.cli import train

    with_val = train.run(_val_cfg(tmp_path, "a", validation_steps=1), sources=[_Pairs()])
    without = train.run(_val_cfg(tmp_path, "b"), sources=[_Pairs()])
    assert len(with_val["losses"]) == 2 and with_val["losses"] == without["losses"]
    assert {"step-1.npy", "step-2.npy"} <= set(os.listdir(tmp_path / "a" / "validation"))
    assert not (tmp_path / "b" / "validation").exists()

"""Pyramid Attention Broadcast: cvd_tpu_torch against cvd_tpu, on the CPU in
f32 at tiny widths.

The schedules are cvd_tpu's, mask for mask. The samplers run with ranges
that reuse every attention class, the epipolar one included, against
cvd_tpu's samplers with the same ``PABConfig`` and the same weights (its
fast init, every tensor drawn, converted with ``state_dict_from_flax``):
final latents at >= 60 dB SNR, the bar of tests/test_torch_slice.py. The
N-view sampler replays cvd_tpu's key chain as tests/test_torch_advanced.py
does. A reuse step runs none of a reused class's attentions, and PAB with
every range 1 is PAB off, bit for bit.
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

from test_torch_advanced import _cameras, _prompt_ids, _replay_reference_draws, _replaying  # noqa: E402,E501
from test_torch_lora import jax_modules, port_modules  # noqa: E402

torch.set_num_threads(1)

Fr, S, IMG = 2, 8, 64  # frames, latent size, pixels
EVERY_CLASS = dict(spatial=2, cross=2, temporal=2, epi=2)


def _snr_db(got, want):
    return 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_modules()


@pytest.fixture(scope="module")
def port_bundle(jax_bundle):
    return port_modules(jax_bundle)


@pytest.mark.parametrize("steps", [1, 2, 3, 6, 10, 25, 50])
def test_reuse_masks_are_cvd_tpus(steps):
    from cvd_tpu.pipelines import pab as jpab
    from cvd_tpu_torch.pipelines import pab

    assert pab.CLASSES == jpab.CLASSES
    for text in ("", "spatial=3,cross=4,temporal=2,epi=2", "epi=3,start_frac=0.0,end_frac=1.0",
                 "spatial=1,cross=1,temporal=1,epi=1", "temporal=5,start_frac=0.5"):
        cfg, jcfg = pab.PABConfig.from_string(text), jpab.PABConfig.from_string(text)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        got, want = pab.reuse_masks(steps, cfg), jpab.reuse_masks(steps, jcfg)
        assert set(got) == set(want)
        for c in got:
            np.testing.assert_array_equal(got[c], want[c], err_msg=f"{text} {c}")
    with pytest.raises(ValueError, match="unknown PAB class"):
        pab.PABConfig.from_string("attn=2")


def _two_view_inputs(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Fr, IMG, IMG, 6)).astype(np.float32),
            (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32),
            rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32))


def _port_two_view(port_bundle, pab_config, steps=6):
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    plucker, F_mats, lat0 = _two_view_inputs()
    ids, neg = _prompt_ids()
    return SimplePipeline(port_bundle, F_mat_size=256, rand_slope_ff=False)(
        torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker),
        torch.from_numpy(F_mats), num_inference_steps=steps, latents=torch.from_numpy(lat0),
        decode=False, pab_config=pab_config)


def test_two_view_pab_matches_jax(jax_bundle, port_bundle):
    from cvd_tpu.pipelines.pab import PABConfig as JaxPAB
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline
    from cvd_tpu_torch.pipelines.pab import PABConfig, reuse_masks

    assert all(reuse_masks(6, PABConfig(**EVERY_CLASS))[c].any() for c in EVERY_CLASS)
    plucker, F_mats, lat0 = _two_view_inputs()
    ids, neg = _prompt_ids()
    want = np.asarray(JaxPipeline(jax_bundle, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), jnp.asarray(F_mats),
        num_inference_steps=6, rng=jax.random.key(0), latents=jnp.asarray(lat0),
        decode=False, pab_config=JaxPAB(**EVERY_CLASS)))
    got = _port_two_view(port_bundle, PABConfig(**EVERY_CLASS)).numpy()
    assert _snr_db(got, want) >= 60.0, f"latent SNR {_snr_db(got, want):.1f} dB < 60 dB"
    # and PAB changed the result by far more than the two packages differ
    off = _port_two_view(port_bundle, None).numpy()
    assert _snr_db(off, want) < _snr_db(got, want) - 20.0, (_snr_db(off, want),
                                                            _snr_db(got, want))


def test_every_range_one_is_pab_off_bit_for_bit(port_bundle):
    from cvd_tpu_torch.pipelines.pab import PABConfig

    ones = PABConfig(spatial=1, cross=1, temporal=1, epi=1)
    assert torch.equal(_port_two_view(port_bundle, ones, steps=3),
                       _port_two_view(port_bundle, None, steps=3))


def test_a_reuse_step_runs_none_of_the_reused_attentions(port_bundle):
    """Forward hooks count each attention class's calls per UNet call: a
    reused class runs no attention (nor what feeds only it) on its reuse
    steps, and the others run as on a computing step."""
    from cvd_tpu_torch.models.epi import EpiSelfAttention
    from cvd_tpu_torch.models.layers import Attention
    from cvd_tpu_torch.models.motion import TemporalSelfAttention
    from cvd_tpu_torch.pipelines.pab import PABConfig, reuse_masks

    unet = port_bundle.unet
    counts, calls = {}, []
    kinds = {}
    for name, mod in unet.named_modules():
        if isinstance(mod, Attention):
            kinds[mod] = "spatial" if name.endswith("attn1") else "cross"
        elif isinstance(mod, TemporalSelfAttention):
            kinds[mod] = "temporal"
        elif isinstance(mod, EpiSelfAttention):
            kinds[mod] = "epi"

    def count(mod, args, out):
        counts[kinds[mod]] = counts.get(kinds[mod], 0) + 1

    def per_call(mod, args, out):
        calls.append(dict(counts))
        counts.clear()

    handles = [m.register_forward_hook(count) for m in kinds]
    handles.append(unet.register_forward_hook(per_call))
    cfg = PABConfig(spatial=2, cross=3, temporal=2, epi=2, start_frac=0.0, end_frac=1.0)
    try:
        _port_two_view(port_bundle, cfg)
    finally:
        for h in handles:
            h.remove()

    masks = reuse_masks(6, cfg)
    full = {c: sum(k == c for k in kinds.values()) for c in EVERY_CLASS}
    assert len(calls) == 6 and all(n > 0 for n in full.values())
    for i, got in enumerate(calls):
        for c in EVERY_CLASS:
            assert got.get(c, 0) == (0 if masks[c][i] else full[c]), (i, c, got)


@pytest.mark.parametrize("batched", [False, True], ids=["loop", "accumulate_batched"])
def test_four_view_pab_matches_jax(jax_bundle, port_bundle, batched):
    """4 views, 3 steps, multistep 2, accumulate 2: the flags follow the
    timestep, so the repeats and pairings of step 1 all reuse, from the one
    cache of the request."""
    from cvd_tpu.pipelines.advanced import AdvancedPipeline as JaxPipeline
    from cvd_tpu.pipelines.pab import PABConfig as JaxPAB
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline
    from cvd_tpu_torch.pipelines.pab import PABConfig

    V, STEPS, MULTI, ACC = 4, 3, 2, 2
    ranges = dict(EVERY_CLASS, start_frac=0.0, end_frac=1.0)
    plucker, c2w, K = _cameras(V)
    lat0 = np.random.default_rng(5).standard_normal((V, Fr, S, S, 4)).astype(np.float32)
    ids, neg = _prompt_ids()
    key = jax.random.key(11)
    want = np.asarray(JaxPipeline(jax_bundle, F_mat_size=IMG, rand_slope_ff=False,
                                  use_flash_kernel=False, accumulate_batched=batched)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), c2w=jnp.asarray(c2w),
        K_mats=jnp.asarray(K), num_inference_steps=STEPS, multistep=MULTI,
        accumulate_step=ACC, rng=key, latents=jnp.asarray(lat0), decode=False,
        pab_config=JaxPAB(**ranges)))
    partners, noises = _replay_reference_draws(key, V, lat0.shape, STEPS, MULTI, ACC)
    pipe = _replaying(AdvancedPipeline, partners, noises)(
        port_bundle, F_mat_size=IMG, rand_slope_ff=False, accumulate_batched=batched)
    got = pipe(torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker),
               c2w=torch.from_numpy(c2w), K_mats=torch.from_numpy(K),
               num_inference_steps=STEPS, multistep=MULTI, accumulate_step=ACC,
               latents=torch.from_numpy(lat0), decode=False,
               pab_config=PABConfig(**ranges)).numpy()
    assert not partners and not noises
    assert len(pipe.unet_step_ms) == (MULTI * (STEPS - 1) + 1) * (1 if batched else ACC)
    assert _snr_db(got, want) >= 60.0, f"latent SNR {_snr_db(got, want):.1f} dB < 60 dB"


def test_cache_lives_only_as_long_as_the_request(port_bundle):
    """No module keeps the request's cache: nothing new hangs on the UNet."""
    from cvd_tpu_torch.pipelines.pab import PABConfig

    before = {n: set(vars(m)) for n, m in port_bundle.unet.named_modules()}
    _port_two_view(port_bundle, PABConfig(**EVERY_CLASS), steps=3)
    assert {n: set(vars(m)) for n, m in port_bundle.unet.named_modules()} == before

"""The N-view sampler: cvd_tpu_torch against cvd_tpu, module by module and
end to end, on the CPU at f32 from tiny configs and numpy-seeded inputs.

The end-to-end bar is the one cvd_tpu holds against its torch oracle:
final latents at >= 60 dB SNR (tests/test_reference_golden.py:823-825).
The reference draws its pairings and re-noise from a chain of split keys;
the golden test replays that chain and hands the port the same partners
and noises through ``AdvancedPipeline.draw_pairing`` / ``draw_noise``.
Modules in f32 agree to 1e-4 of max |ref| (summation order), host-side
numpy geometry to 1e-12.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_modules import close, port, t  # noqa: E402
from test_torch_slice import _perturbed, _port_modules  # noqa: E402

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
Fr, S, IMG = 2, 8, 64  # frames, latent size, pixels


def _snr_db(got, want):
    return 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))


@pytest.fixture(scope="module")
def jax_bundle():
    """The JAX tiny bundle with perturbed UNet and pose-encoder params, so
    that the zero-initialized epi and pose-merge layers take part."""
    from tiny import tiny_modules

    base = tiny_modules(latent_size=S, video_length=Fr)
    params = _perturbed(base.unet_params, 0)
    return dataclasses.replace(base, unet_params=jax.tree_util.tree_map(jnp.asarray, params),
                               pose_encoder_params=_perturbed(base.pose_encoder_params, 1))


@pytest.fixture(scope="module")
def port_bundle(jax_bundle):
    return _port_modules(jax_bundle)


def _cameras(V):
    from cvd_tpu.geometry.plucker import ray_condition
    from cvd_tpu.geometry.trajectories import circle_trajectory, default_intrinsics

    c2ws = circle_trajectory(V, Fr, camera_dist=0.3)
    K = default_intrinsics(V, Fr, IMG, IMG)
    intr = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], -1).astype(np.float32)
    plucker = np.asarray(ray_condition(intr[None], c2ws[None].astype(np.float32), IMG, IMG)[0])
    return (plucker.reshape(V, Fr, IMG, IMG, 6).astype(np.float32), c2ws.astype(np.float32),
            K.astype(np.float32))


def _prompt_ids():
    """The port's hash tokenizer (CRC-32): the same ids in every process.
    cvd_tpu's hashes with Python's ``hash``, salted per process, which would
    make these inputs change from one test process to the next."""
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    tok = HashTokenizer()
    return tok(["a parity scene"]), tok(["blurry"])


# ------------------------------------------------------------ the pipeline

def _replay_reference_draws(key, V, shape, steps, multistep, accumulate_step):
    """The partners and re-noise tensors cvd_tpu's AdvancedPipeline draws from
    ``key``, in the order the port asks for them (advanced.py:174, :432, :454,
    :342, :460). On the last timestep only the first repeat is kept."""
    from cvd_tpu.pipelines.advanced import random_pairing

    partners, noises = [], []
    k, _init_key = jax.random.split(key)
    for step in range(steps):
        for rep in range(multistep):
            k, acc_key = jax.random.split(k)
            acc_keys = ([acc_key] if accumulate_step == 1
                        else list(jax.random.split(acc_key, accumulate_step)))
            k, nk = jax.random.split(k)
            if step == steps - 1 and rep > 0:
                continue
            for ak in acc_keys:
                pair_key, _slope_key = jax.random.split(ak)
                partners.append(np.asarray(random_pairing(pair_key, V)))
            if rep != multistep - 1 and step != steps - 1:
                noises.append(np.asarray(jax.random.normal(nk, shape, jnp.float32)))
    return partners, noises


def _replaying(pipeline_cls, partners, noises):
    class Replaying(pipeline_cls):
        def draw_pairing(self, generator, num_views):
            return t(partners.pop(0)).long()

        def draw_noise(self, generator, shape):
            return t(noises.pop(0))

    return Replaying


def test_advanced_pipeline_four_views_matches_jax(jax_bundle, port_bundle):
    from cvd_tpu.pipelines.advanced import AdvancedPipeline as JaxPipeline
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    V, STEPS, MULTI, ACC = 4, 2, 2, 2
    plucker, c2w, K = _cameras(V)
    lat0 = np.random.default_rng(5).standard_normal((V, Fr, S, S, 4)).astype(np.float32)
    ids, neg = _prompt_ids()
    key = jax.random.key(11)

    want = np.asarray(JaxPipeline(jax_bundle, F_mat_size=IMG, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), c2w=jnp.asarray(c2w),
        K_mats=jnp.asarray(K), num_inference_steps=STEPS, guidance_scale=8.5,
        multistep=MULTI, accumulate_step=ACC, rng=key, latents=jnp.asarray(lat0),
        decode=False))

    partners, noises = _replay_reference_draws(key, V, lat0.shape, STEPS, MULTI, ACC)
    assert len(partners) == (MULTI + 1) * ACC and len(noises) == MULTI - 1
    assert len({tuple(p) for p in partners}) > 1   # the routing does change between calls
    pipe = _replaying(AdvancedPipeline, partners, noises)(port_bundle, F_mat_size=IMG,
                                                          rand_slope_ff=False)
    got = pipe(torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker),
               c2w=torch.from_numpy(c2w), K_mats=torch.from_numpy(K),
               num_inference_steps=STEPS, guidance_scale=8.5, multistep=MULTI,
               accumulate_step=ACC, latents=torch.from_numpy(lat0), decode=False).numpy()
    assert not partners and not noises              # every replayed draw was asked for
    assert got.shape == want.shape == (V, Fr, S, S, 4)
    assert len(pipe.unet_step_ms) == (MULTI + 1) * ACC
    assert _snr_db(got, want) >= 60.0, f"latent SNR {_snr_db(got, want):.1f} dB < 60 dB"


def test_accumulate_batched_equals_the_loop(port_bundle):
    """The accumulate_step pairings as one UNet call at batch 2V*A give what
    the loop of A calls gives (same generator, so the same pairings; the
    slopes are fixed): 1e-5 x max |loop|."""
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    V = 4
    plucker, c2w, K = _cameras(V)
    ids, neg = _prompt_ids()
    out = []
    for batched in (False, True):
        pipe = AdvancedPipeline(port_bundle, F_mat_size=IMG, rand_slope_ff=False,
                                accumulate_batched=batched)
        out.append(pipe(torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker),
                        c2w=torch.from_numpy(c2w), K_mats=torch.from_numpy(K),
                        num_inference_steps=2, multistep=2, accumulate_step=2,
                        generator=torch.Generator().manual_seed(5), decode=False).numpy())
        assert len(pipe.unet_step_ms) == (3 if batched else 6)
    loop, one_call = out
    assert np.abs(one_call - loop).max() <= 1e-5 * np.abs(loop).max()


def test_advanced_two_view_fixed_pairs_match_jax_and_the_simple_pipeline(jax_bundle,
                                                                        port_bundle):
    """V == 2 with fixed F_mats: the half swap over interleaved CFG rows.
    Against cvd_tpu's AdvancedPipeline (>= 60 dB), and against the port's
    SimplePipeline, whose CFG rows are chunk-ordered: the same latents."""
    from cvd_tpu.pipelines.advanced import AdvancedPipeline as JaxPipeline
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    rng = np.random.default_rng(2)
    plucker = rng.standard_normal((2, Fr, IMG, IMG, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    lat0 = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    ids, neg = _prompt_ids()
    want = np.asarray(JaxPipeline(jax_bundle, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), F_mats=jnp.asarray(F_mats),
        num_inference_steps=2, guidance_scale=8.5, rng=jax.random.key(0),
        latents=jnp.asarray(lat0), decode=False))
    args = (torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker))
    kw = dict(num_inference_steps=2, guidance_scale=8.5, latents=torch.from_numpy(lat0),
              decode=False)
    got = AdvancedPipeline(port_bundle, F_mat_size=256, rand_slope_ff=False)(
        *args, F_mats=torch.from_numpy(F_mats), **kw).numpy()
    assert _snr_db(got, want) >= 60.0, f"latent SNR {_snr_db(got, want):.1f} dB < 60 dB"
    simple = SimplePipeline(port_bundle, F_mat_size=256, rand_slope_ff=False)(
        *args, torch.from_numpy(F_mats), **kw).numpy()
    assert np.abs(got - simple).max() <= 1e-5 * np.abs(simple).max()


def test_advanced_pipeline_refusals(port_bundle):
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    ids = torch.zeros(1, 77, dtype=torch.int32)
    pipe = AdvancedPipeline(port_bundle)
    # PAB is taken (tests/test_torch_pab.py); a config that is none is not
    with pytest.raises(AttributeError):
        pipe(ids, ids, torch.zeros(2, Fr, IMG, IMG, 6), F_mats=torch.zeros(2, Fr, 3, 3),
             pab_config=object())
    with pytest.raises(ValueError, match="c2w"):
        pipe(ids, ids, torch.zeros(4, Fr, IMG, IMG, 6))
    with pytest.raises(ValueError, match="even"):
        pipe(ids, ids, torch.zeros(3, Fr, IMG, IMG, 6), c2w=torch.zeros(3 * Fr, 4, 4),
             K_mats=torch.zeros(3 * Fr, 3, 3))


def test_advanced_homography_path_runs(port_bundle):
    """H_mats conditioning (a slope per row from the generator): finite
    latents, and another seed gives other lines."""
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    ids, neg = _prompt_ids()
    plucker, _, _ = _cameras(2)
    H_mats = torch.eye(3).expand(2, Fr, 3, 3)
    lat0 = torch.from_numpy(np.random.default_rng(6).standard_normal((2, Fr, S, S, 4))
                            .astype(np.float32))
    outs = [AdvancedPipeline(port_bundle, F_mat_size=IMG)(
        torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker), H_mats=H_mats,
        num_inference_steps=2, generator=torch.Generator().manual_seed(seed), latents=lat0,
        decode=False) for seed in (0, 0, 1)]
    assert all(torch.isfinite(o).all() and o.shape == (2, Fr, S, S, 4) for o in outs)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("V", [2, 4, 6, 8])
def test_random_pairing_is_a_perfect_matching(V):
    from cvd_tpu_torch.pipelines.advanced import random_pairing

    g = torch.Generator().manual_seed(V)
    seen = set()
    for _ in range(8):
        partner = random_pairing(g, V).numpy()
        assert partner.shape == (V,)
        assert (partner[partner] == np.arange(V)).all() and (partner != np.arange(V)).all()
        seen.add(tuple(partner))
    assert V == 2 or len(seen) > 1


def test_interleave_cfg_is_repeat_interleave():
    from cvd_tpu.pipelines.advanced import interleave_cfg as jax_interleave
    from cvd_tpu_torch.pipelines.advanced import interleave_cfg

    x = np.arange(12, dtype=np.float32).reshape(3, 2, 2)
    np.testing.assert_array_equal(interleave_cfg(t(x)).numpy(),
                                  np.asarray(jax_interleave(jnp.asarray(x))))


def test_kv_index_of_a_pairing_matches_the_reference_formula():
    """Row r of view v goes to the same CFG row and frame of its partner
    view: kv_index = row + (partner[row_v] - row_v) * 2F, an involution
    that keeps the (cfg, frame) offset."""
    V, F2 = 4, 2 * Fr
    partner = np.array([2, 3, 0, 1])
    row = np.arange(V * F2)
    kv = row + (partner[row // F2] - row // F2) * F2
    assert (kv[kv] == row).all() and (kv % F2 == row % F2).all()
    assert (kv // F2 == partner[row // F2]).all()


# ------------------------------------------------------------- epi routing

def _epi_case(kind, monkeypatch):
    """EpiTransformer (LN -> EpiSelfAttention blocks -> FF) on both sides,
    converted weights, for one routing case."""
    from cvd_tpu.models import epi as jepi
    from cvd_tpu_torch.models import epi as pepi

    feat, C, HEADS, Fw = (16 if kind == "kv_index_kernel_site" else 8), 32, 4, 2
    views, cfg = 4, (2 if kind == "fix_firstframe" else 1)
    B = views * cfg                       # videos x cfg rows; frame rows = B * Fw
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, Fw, feat, feat, C)).astype(np.float32)
    rows = B * Fw
    m = 2 if kind == "multi_group" else 1
    F_mats = (rng.standard_normal((m * rows, 3, 3)) * 1e-3).astype(np.float32)
    kv_index = None
    if kind != "fix_firstframe":
        kv_index = np.concatenate([rng.permutation(rows) for _ in range(m)]).astype(np.int32)
    common = dict(video_length=Fw, F_mat_size=256, rand_slope_ff=False,
                  fix_firstframe=kind == "fix_firstframe", cfg_factor=cfg)
    jm = jepi.EpiTransformer(in_channels=C, heads=HEADS, norm_groups=8, zero_initialize=False)
    jcond = jepi.EpiConditioning(
        F_mats=jnp.asarray(F_mats), kv_index=None if kv_index is None else jnp.asarray(kv_index),
        use_flash_kernel=False, **common)
    v = jm.init({"params": jax.random.key(4)}, jnp.asarray(x), jcond)
    want, _ = jm.apply(v, jnp.asarray(x), jcond)
    pm = port(pepi.EpiTransformer(C, heads=HEADS, norm_groups=8), v)
    pcond = pepi.EpiConditioning(
        F_mats=t(F_mats), kv_index=None if kv_index is None else t(kv_index), **common)
    with torch.no_grad():
        return pm(t(x), pcond), want


@pytest.mark.parametrize("kind", ["kv_index", "kv_index_kernel_site", "multi_group",
                                  "fix_firstframe"])
def test_epi_routing_matches_jax(kind, monkeypatch):
    """An explicit kv_index (on a small grid: gathered rows; on a 16 x 16
    grid: routed inside the attention), a multi-group kv_index of 2B rows,
    and fix_firstframe with cfg_factor 2."""
    got, want = _epi_case(kind, monkeypatch)
    close(got, want, f"epi {kind}")


def test_route_is_built_once_per_call():
    from cvd_tpu_torch.models.epi import EpiConditioning

    cond = EpiConditioning(F_mats=torch.zeros(8, 3, 3))
    r = cond.route(8, "cpu")
    assert r.tolist() == [4, 5, 6, 7, 0, 1, 2, 3] and r.dtype == torch.int32
    assert cond.route(8, "cpu") is r
    kv = torch.tensor([1, 0, 3, 2])
    cond = EpiConditioning(kv_index=kv)
    assert cond.route(4, "cpu").tolist() == [1, 0, 3, 2] and cond.route(4, "cpu") is cond._route


def test_gather_and_regroup_match_jax():
    from cvd_tpu.models.epi import gather_partner_tokens as jg, regroup_bias as jr
    from cvd_tpu_torch.models.epi import gather_partner_tokens, regroup_bias

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)
    for idx in (None, np.array([2, 3, 0, 1]), np.array([1, 0, 3, 2, 2, 3, 0, 1])):
        want = jg(jnp.asarray(x), None if idx is None else jnp.asarray(idx))
        got = gather_partner_tokens(t(x), None if idx is None else t(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bias = rng.standard_normal((8, 5, 5)).astype(np.float32)
    np.testing.assert_array_equal(regroup_bias(t(bias), 4).numpy(),
                                  np.asarray(jr(jnp.asarray(bias), 4)))
    assert regroup_bias(t(bias), 8).shape == (8, 5, 5)


# ------------------------------------------------------------------- lines

def test_homography_lines_match_jax():
    from cvd_tpu.geometry.epipolar_mask import homography_lines as jh, pixel_grid_coords as jc
    from cvd_tpu_torch.geometry.epipolar_mask import homography_lines, pixel_grid_coords

    rng = np.random.default_rng(9)
    H = (np.eye(3) + rng.standard_normal((6, 3, 3)) * 0.05).astype(np.float32)
    slope = rng.uniform(0, np.pi, 6).astype(np.float32)
    want = jh(jnp.asarray(H), jc(8, 256), 256, jnp.asarray(slope))
    close(homography_lines(t(H), pixel_grid_coords(8, 256), 256, t(slope)), want, "H lines")


@pytest.mark.parametrize("path", ["H_mats", "pose_free"])
def test_epi_lines_other_paths_match_jax(path, monkeypatch):
    """The homography and the pose-free path of ``_epi_lines``, a slope per
    row, the same slopes on both sides."""
    from cvd_tpu.models import epi as jepi
    from cvd_tpu_torch.models import epi as pepi

    B, feat = 6, 8
    rng = np.random.default_rng(10)
    slope = rng.uniform(0, np.pi, B).astype(np.float32)
    H = (np.eye(3) + rng.standard_normal((B, 3, 3)) * 0.05).astype(np.float32)
    monkeypatch.setattr(jepi, "_uniform_slope", lambda rng_, shape: jnp.asarray(slope))
    kw = dict(video_length=2, F_mat_size=256)
    jcond = jepi.EpiConditioning(H_mats=jnp.asarray(H) if path == "H_mats" else None, **kw)
    want = jepi._epi_lines(jcond, B, feat, jax.random.key(0))
    pcond = pepi.EpiConditioning(H_mats=t(H) if path == "H_mats" else None, slope=t(slope), **kw)
    got = pepi._epi_lines(pcond, B, feat, "cpu")
    close(got, want, f"lines {path}")
    # without a given slope they come from the generator, one per row
    drawn = pepi._epi_lines(dataclasses.replace(pcond, slope=None,
                                                generator=torch.Generator().manual_seed(0)),
                            B, feat, "cpu")
    assert drawn.shape == got.shape and len({float(a) for a in drawn[:, 0, 0]}) == B
    with pytest.raises(ValueError, match="generator"):
        pepi._epi_lines(dataclasses.replace(pcond, slope=None), B, feat, "cpu")


# -------------------------------------------------- geometry and scheduler

def test_fundamental_between_views_torch_matches_jax_and_numpy():
    from cvd_tpu.geometry.epipolar import fundamental_between_views as jf
    from cvd_tpu_torch.geometry.epipolar import (
        fundamental_between_views, fundamental_between_views_torch,
    )

    _, c2w, K = _cameras(4)
    src, dst = c2w[:2 * Fr], c2w[2 * Fr:]
    want = np.asarray(jf(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(K[:2 * Fr]),
                         jnp.asarray(K[2 * Fr:])))
    got = fundamental_between_views_torch(t(src), t(dst), t(K[:2 * Fr]), t(K[2 * Fr:]))
    assert got.dtype == torch.float32
    close(got, want, "F (jax)", rel=1e-5)
    close(got, fundamental_between_views(src.astype(np.float64), dst.astype(np.float64),
                                         K[:2 * Fr].astype(np.float64),
                                         K[2 * Fr:].astype(np.float64)), "F (numpy f64)", rel=1e-5)


@pytest.mark.parametrize("steps", [2, 25])
def test_renoise_matches_jax(steps):
    from cvd_tpu.schedulers import DDIMScheduler as JS
    from cvd_tpu_torch.schedulers import DDIMScheduler as PS

    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 3, 4)).astype(np.float32)
    js, ps = JS(), PS()
    jst, pst = js.set_timesteps(steps), ps.set_timesteps(steps)
    for tt in np.asarray(jst.timesteps):
        want = js.renoise(jst, jnp.asarray(x), int(tt), jnp.asarray(noise))
        close(ps.renoise(pst, t(x), int(tt), t(noise)), want, f"renoise t={tt}", rel=1e-6)


@pytest.mark.parametrize("pattern", ["circle_trajectory", "upper_hemi_trajectory",
                                     "interpolate_trajectories"])
def test_trajectories_match_cvd_tpu(pattern):
    from cvd_tpu.geometry import trajectories as jt
    from cvd_tpu_torch.geometry import trajectories as pt

    want = getattr(jt, pattern)(4, 5, 0.7)
    got = getattr(pt, pattern)(4, 5, 0.7)
    assert got.shape == (20, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # a seeded perturbation of the trajectories' end points
    want = getattr(jt, pattern)(4, 5, 0.7, 0.1, np.random.default_rng(3))
    got = getattr(pt, pattern)(4, 5, 0.7, 0.1, np.random.default_rng(3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(got - getattr(pt, pattern)(4, 5, 0.7)).max() > 1e-3
    with pytest.raises(ValueError, match="Generator"):
        getattr(pt, pattern)(4, 5, 0.7, 0.1)


def test_pose_interpolation_and_intrinsics_match_cvd_tpu():
    from cvd_tpu.geometry import trajectories as jt
    from cvd_tpu_torch.geometry import trajectories as pt

    src = pt.circle_trajectory(2, 3, 0.5)[:3]
    tgt = pt.upper_hemi_trajectory(2, 3, 0.9)[3:]
    np.testing.assert_allclose(pt.interpolate_pose_batch(src, tgt, 4),
                               jt.interpolate_pose_batch(src, tgt, 4), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.interpolate_pose(src[0], tgt[2], 5),
                               jt.interpolate_pose(src[0], tgt[2], 5), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(pt.default_intrinsics(4, 2, 64, 128),
                                  jt.default_intrinsics(4, 2, 64, 128))


# ----------------------------------------------------------------- the CLI

def _cli_args(tmp_path, *extra, device="cpu"):
    from cvd_tpu_torch.cli import inference_advanced

    argv = ["--random-weights", "--view_num", "4", "--video_length", "2",
            "--image_height", "64", "--image_width", "64", "--num_inference_steps", "2",
            "--multistep", "2", "--caption_file", os.path.join(ASSETS, "example_prompts.json"),
            "--use_negative_prompt", "--out_root", str(tmp_path / "out")]
    if device:
        argv += ["--device", device]
    return inference_advanced.build_parser().parse_args(argv + list(extra))


def test_inference_advanced_cli_random_weights(tmp_path):
    """The N-view CLI as a user runs it, tiny random weights, on the CPU;
    transforms.json equal to what cvd_tpu's CLI writes for these cameras."""
    from cvd_tpu.cli import inference_advanced as jax_cli
    from cvd_tpu_torch.cli import inference_advanced

    args = _cli_args(tmp_path)
    records = inference_advanced.main(args)
    assert len(records) == 2
    c2ws, K = jax_cli.build_cameras(args)
    np.testing.assert_allclose(inference_advanced.build_cameras(args)[0], c2ws, atol=1e-12)
    intr = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], -1).astype(np.float32)
    frames = [(os.path.join("images", str(v), f"{i:04d}.png"), c2ws[v * 2 + i])
              for v in range(4) for i in range(2)]
    jax_cli.export_transforms_json(str(tmp_path / "want.json"), intr, c2ws, frames, args)
    with open(tmp_path / "want.json") as f:
        want = json.load(f)
    for idx, rec in enumerate(records):
        v = rec["videos"]
        assert v.shape == (4, 2, 64, 64, 3) and np.isfinite(v).all()
        assert len(rec["unet_step_ms"]) == 3 and rec["seconds"] > 0   # 2 + 1 calls
        sub = tmp_path / "out" / f"0_{idx:04d}"
        assert rec["out"] == str(sub)
        saved = np.load(sub / "videos.npy")
        assert saved.dtype == np.uint8 and saved.shape == (4, 2, 64, 64, 3)
        with open(sub / "transforms.json") as f:
            got = json.load(f)
        assert got == want
        assert got["frames"][0]["transform_matrix"][1][1] == -c2ws[0][1][1]   # the y flip


@pytest.mark.parametrize("extra,error", [
    (["--view_num", "3"], SystemExit),
    (["--image_width", "128"], SystemExit),
    (["--pab", "--pab_ranges", "attn=2"], ValueError),
    (["--sharded"], RuntimeError),       # without torchrun's environment
    (["--mono_direction"], NotImplementedError),
])
def test_inference_advanced_cli_refuses(tmp_path, monkeypatch, extra, error):
    from cvd_tpu_torch.cli import inference_advanced
    from cvd_tpu_torch.parallel.mesh import TORCHRUN_ENV

    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(error, match="torchrun" if extra == ["--sharded"] else None):
        inference_advanced.main(_cli_args(tmp_path, *extra))
    assert not os.path.exists(tmp_path / "out")    # refused before anything was written


def test_inference_advanced_cli_takes_the_reference_flags(tmp_path):
    """--zero_first_frame_scale, a no-op here as in cvd_tpu (procedural
    trajectories start at identity), parses as cvd_tpu's parser has it; --pab
    runs the sampler with Pyramid Attention Broadcast."""
    from cvd_tpu.cli import inference_advanced as jax_cli
    from cvd_tpu_torch.cli import inference_advanced

    args = _cli_args(tmp_path, "--zero_first_frame_scale", "--pab", "--pab_ranges",
                     "spatial=2,start_frac=0.0")
    assert args.zero_first_frame_scale is True
    want = {a.dest: a.help for a in jax_cli.build_parser()._actions}
    got = {a.dest: a.help for a in inference_advanced.build_parser()._actions}
    assert got["zero_first_frame_scale"] == want["zero_first_frame_scale"]
    args.caption_file = os.path.join(ASSETS, "example_prompts.json")
    (rec, _) = inference_advanced.main(args)
    assert rec["videos"].shape == (4, 2, 64, 64, 3) and np.isfinite(rec["videos"]).all()


def test_inference_advanced_cli_refuses_a_silent_cpu_run(tmp_path, monkeypatch):
    from cvd_tpu_torch.cli import inference_advanced

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_args(tmp_path, device=None)
    assert args.device is None
    with pytest.raises(RuntimeError, match="--device cpu"):
        inference_advanced.main(args)
    assert not os.path.exists(tmp_path / "out")

"""The samplers' execution model: one prepared request, then a timestep
body run over chunks of timesteps (``cvd_tpu_torch/pipelines/program.py``).
On the card the body is captured as a CUDA graph and replayed; on the CPU,
where these tests run, the same body runs eagerly.

Held against cvd_tpu at the tiny configs, on the CPU in f32:

* the DDIM step and re-noise with the timestep as a tensor (the form a
  graph replays) against cvd_tpu's traced scheduler, over every timestep
  of 2-, 3- and 25-step schedules, the ``prev < 0`` end included (1e-6
  relative);
* the N-view sampler at ``step_chunk`` 1, 2 and 3 (3 steps, multistep 2,
  accumulate 2: a ragged last chunk at 2) against cvd_tpu's chunked run
  (``_call_chunked``) and its whole run, the pairings and re-noise pinned
  to cvd_tpu's through ``draw_pairing`` / ``draw_noise``: 1e-5 x max
  |latent|, and the port's chunked runs bit-equal to its unchunked run;
* the 2-view sampler with multidiff windows through the timestep body
  against cvd_tpu (>= 60 dB, tests/test_torch_multidiff.py's bar).

And what a captured body must be: a function of the program's buffers
alone. A body is kept from one request (with every Python object it
closed over) and run again on the buffers of another request, as a graph
replay would: that request's eager latents, bit for bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_advanced import (  # noqa: E402
    _cameras, _prompt_ids, _replay_reference_draws, _replaying,
)
from test_torch_lora import jax_modules, port_modules  # noqa: E402
from test_torch_modules import t  # noqa: E402

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
Fr, S, IMG = 2, 8, 64                      # frames, latent size, pixels
V, STEPS, MULTI, ACC = 4, 3, 2, 2          # the chunked N-view request


@pytest.fixture(scope="module")
def bundles():
    jm = jax_modules()
    return jm, port_modules(jm)


# --------------------------------------------------------------- scheduler

@pytest.mark.parametrize("steps", [2, 3, 25])
@pytest.mark.parametrize("fn", ["step", "renoise"])
def test_device_timestep_matches_the_traced_scheduler(steps, fn):
    """Every timestep of the schedule as a 0-dim int64 tensor (what a graph
    reads from its timestep buffer), against cvd_tpu's step / renoise with
    a traced timestep; the last step's previous timestep is negative and
    takes the final alpha."""
    from cvd_tpu.schedulers.ddim import DDIMScheduler as JD
    from cvd_tpu_torch.schedulers.ddim import DDIMScheduler as PD

    jd, pd = JD(), PD()
    js, ps = jd.set_timesteps(steps), pd.set_timesteps(steps)
    rng = np.random.default_rng(steps)
    x = (rng.standard_normal((2, 3, 4)) * 2).astype(np.float32)
    y = rng.standard_normal((2, 3, 4)).astype(np.float32)
    if fn == "step":
        traced = jax.jit(lambda tt: jd.step(js, jnp.asarray(y), tt, jnp.asarray(x)))
    else:
        traced = jax.jit(lambda tt: jd.renoise(js, jnp.asarray(x), tt, jnp.asarray(y)))
    prev = ps.timesteps - pd.num_train_timesteps // steps
    assert prev[-1] < 0 <= prev[:-1].min()
    for tt in ps.timesteps:
        timestep = torch.tensor(int(tt))
        got = (pd.step(ps, t(y), timestep, t(x)) if fn == "step"
               else pd.renoise(ps, t(x), timestep, t(y)))
        want = np.asarray(traced(jnp.asarray(tt, jnp.int32)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------ the program

def test_chunks_split_the_timesteps_by_their_repeats():
    from cvd_tpu_torch.pipelines.program import chunks

    repeats = [2, 2, 1]          # 3 steps, multistep 2: the last taken once
    assert chunks(repeats) == [(0, 1, (2,)), (1, 2, (2,)), (2, 3, (1,))]
    assert chunks(repeats, 2) == [(0, 2, (2, 2)), (2, 3, (1,))]
    assert chunks(repeats, 3) == chunks(repeats, 9) == [(0, 3, (2, 2, 1))]
    with pytest.raises(ValueError, match="at least one"):
        chunks(repeats, 0)


def test_span_timer_gives_a_replay_one_entry_per_call():
    from cvd_tpu_torch.utils.tracing import SpanTimer

    timer = SpanTimer("cpu")
    with timer:
        pass
    with timer.span(4):
        pass
    with timer:
        pass
    ms = timer.elapsed_ms()
    assert len(ms) == 6 and ms[1] == ms[2] == ms[3] == ms[4]


def test_the_cpu_runs_the_body_eagerly(bundles):
    """On the CPU the program runs eagerly whatever ``capture`` says, and a
    host generator is taken; its stats count the body's UNet calls."""
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    _, pm = bundles
    plucker, c2w, K = _cameras(V)
    ids, neg = _prompt_ids()
    pipe = AdvancedPipeline(pm, F_mat_size=IMG, rand_slope_ff=False)
    assert pipe.program.capture is False
    pipe(t(ids), t(neg), t(plucker), c2w=t(c2w), K_mats=t(K), num_inference_steps=2,
         multistep=2, accumulate_step=2, generator=torch.Generator().manual_seed(1),
         decode=False)
    stats = pipe.program.stats
    assert stats["captured"] is False and stats["captures"] == 0
    assert stats["unet_calls"] == len(pipe.unet_step_ms) == (MULTI + 1) * ACC


# ------------------------------------------------------- N-view, chunked

def _nview_inputs():
    plucker, c2w, K = _cameras(V)
    lat0 = np.random.default_rng(5).standard_normal((V, Fr, S, S, 4)).astype(np.float32)
    return plucker, c2w, K, lat0


@pytest.fixture(scope="module")
def nview_runs(bundles):
    """cvd_tpu's whole run and the port's unchunked run of the chunked tests'
    request, and the pinned draws."""
    from cvd_tpu.pipelines.advanced import AdvancedPipeline as JaxPipeline

    jm, pm = bundles
    plucker, c2w, K, lat0 = _nview_inputs()
    ids, neg = _prompt_ids()
    key = jax.random.key(11)
    jpipe = JaxPipeline(jm, F_mat_size=IMG, rand_slope_ff=False, use_flash_kernel=False)
    kw = dict(c2w=jnp.asarray(c2w), K_mats=jnp.asarray(K), num_inference_steps=STEPS,
              guidance_scale=8.5, multistep=MULTI, accumulate_step=ACC, rng=key,
              latents=jnp.asarray(lat0), decode=False)
    whole = np.asarray(jpipe(jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), **kw))
    draws = _replay_reference_draws(key, V, lat0.shape, STEPS, MULTI, ACC)
    unchunked = _port_chunked(pm, draws, None)
    return jpipe, kw, whole, draws, unchunked


def _port_chunked(pm, draws, step_chunk):
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    plucker, c2w, K, lat0 = _nview_inputs()
    ids, neg = _prompt_ids()
    partners, noises = (list(d) for d in draws)
    pipe = _replaying(AdvancedPipeline, partners, noises)(pm, F_mat_size=IMG,
                                                          rand_slope_ff=False)
    got = pipe(t(ids), t(neg), t(plucker), c2w=t(c2w), K_mats=t(K),
               num_inference_steps=STEPS, guidance_scale=8.5, multistep=MULTI,
               accumulate_step=ACC, latents=t(lat0), decode=False, step_chunk=step_chunk)
    assert not partners and not noises              # every pinned draw was asked for
    assert len(pipe.unet_step_ms) == pipe.program.stats["unet_calls"] == (
        (STEPS - 1) * MULTI + 1) * ACC
    return got.numpy()


@pytest.mark.parametrize("step_chunk", [1, 2, 3])
def test_step_chunk_matches_cvd_tpu_chunked_and_whole(bundles, nview_runs, step_chunk):
    jm, pm = bundles
    jpipe, kw, whole, draws, unchunked = nview_runs
    plucker, _, _, _ = _nview_inputs()
    ids, neg = _prompt_ids()
    chunked = np.asarray(jpipe(jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), **kw,
                               step_chunk=step_chunk))
    got = _port_chunked(pm, draws, step_chunk)
    assert got.shape == whole.shape == (V, Fr, S, S, 4)
    for want, what in ((chunked, f"cvd_tpu at step_chunk {step_chunk}"), (whole, "whole run")):
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), f"against {what}: max err {err:.3g}"
    np.testing.assert_array_equal(got, unchunked)


# ------------------------------------------------------------- 2 views

def test_two_view_multidiff_body_matches_jax(bundles):
    """Two windows of 2 frames over 3 frames: each timestep's body makes a
    UNet call per window."""
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    jm, pm = bundles
    rng = np.random.default_rng(3)
    plucker = rng.standard_normal((2, 3, IMG, IMG, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, 3, 3, 3)) * 1e-3).astype(np.float32)
    lat0 = rng.standard_normal((2, 3, S, S, 4)).astype(np.float32)
    ids, neg = _prompt_ids()
    want = np.asarray(JaxPipeline(jm, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), jnp.asarray(F_mats),
        num_inference_steps=2, rng=jax.random.key(0), latents=jnp.asarray(lat0), decode=False,
        multidiff_total_steps=2, multidiff_overlaps=1, window_length=2))
    pipe = SimplePipeline(pm, F_mat_size=256, rand_slope_ff=False)
    got = pipe(t(ids), t(neg), t(plucker), t(F_mats), num_inference_steps=2, latents=t(lat0),
               decode=False, multidiff_total_steps=2, multidiff_overlaps=1).numpy()
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    assert snr >= 60.0, f"SNR {snr:.1f} dB"
    assert pipe.program.stats["unet_calls"] == len(pipe.unet_step_ms) == 4


# ------------------------------------------------- the body and its buffers

class _KeptBody:
    """Stands in for a CUDA graph on the CPU: ``_capture`` keeps the body with
    the arguments of its capture (the program's buffers, the timestep buffer,
    the first request's closures) and a replay runs it again on them."""

    def __init__(self, program_mod):
        self.P = program_mod

    def capture(self, program, key, bufs, timesteps, start, reps, body, gen):
        P = self.P
        ts = timesteps.clone()
        state = None if gen is None else gen.get_state()
        calls = body(dict(bufs, latents=bufs["latents"].clone()), ts, start, reps, gen,
                     P.NO_TIMER)
        if gen is not None:
            gen.set_state(state)

        class Replay:
            def replay(self):
                body(bufs, ts, start, reps, gen, P.NO_TIMER)

        graph = program.graphs[key] = P._Graph(Replay(), ts, calls, {})
        program.stats["captures"] += 1
        return graph


@pytest.mark.parametrize("sampler", ["simple", "advanced", "advanced_batched"])
def test_a_kept_body_reads_only_its_buffers(bundles, monkeypatch, sampler):
    """Two requests with other prompts, poses, latents and draws through one
    program whose bodies are kept from the first request and run again on
    the buffers (as a graph replays), each at its eager run's latents bit
    for bit, and the caller's generator left where the eager run leaves it."""
    from cvd_tpu_torch.pipelines import program as P
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    _, pm = bundles
    kept = _KeptBody(P)
    monkeypatch.setattr(P.SamplingProgram, "_capture",
                        lambda self, *a: kept.capture(self, *a))
    monkeypatch.setattr(P.SamplingProgram, "check_generator", lambda self, g: None)
    rng = np.random.default_rng(9)

    def request():
        ids = torch.from_numpy(rng.integers(1, 49405, (1, 77)))
        neg = torch.from_numpy(rng.integers(1, 49405, (1, 77)))
        if sampler == "simple":
            return dict(prompt_ids=ids, negative_ids=neg,
                        plucker=t(rng.standard_normal((2, Fr, IMG, IMG, 6)).astype(np.float32)),
                        F_mats=t((rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)),
                        num_inference_steps=3, decode=False)
        plucker, c2w, K = _cameras(V)
        return dict(prompt_ids=ids, negative_ids=neg, plucker=t(plucker), c2w=t(c2w),
                    K_mats=t(K), num_inference_steps=3, multistep=2, accumulate_step=2,
                    decode=False, step_chunk=2)

    def make(capture):
        if sampler == "simple":
            return SimplePipeline(pm, capture=capture)
        return AdvancedPipeline(pm, F_mat_size=IMG, capture=capture,
                                accumulate_batched=sampler == "advanced_batched")

    eager, kept_pipe = make(False), make(True)
    kept_pipe.program.capture = True            # the capturing branch, on the CPU
    for i, kw in enumerate([request(), request()]):
        g_eager, g_kept = (torch.Generator().manual_seed(20 + i) for _ in range(2))
        want = eager(**kw, generator=g_eager)
        got = kept_pipe(**kw, generator=g_kept)
        assert torch.equal(got, want), f"request {i}"
        assert torch.equal(g_kept.get_state(), g_eager.get_state())
        stats = kept_pipe.program.stats
        # the 2-view body is one graph; the N-view's at step_chunk 2 are two
        assert stats["captured"] and stats["captures"] == ((1 if sampler == "simple" else 2)
                                                           if i == 0 else 0)
        assert len(kept_pipe.unet_step_ms) == len(eager.unet_step_ms) == stats["unet_calls"]


# ---------------------------------------------------- the device-side pieces

def test_corner_coords_and_float_slopes_are_built_on_the_device():
    """The two host-to-device copies a captured UNet call cannot make: the
    band's corner coordinates and a slope given as a number."""
    from cvd_tpu_torch.geometry.epipolar_mask import _corner_coords, pseudo_lines

    for feat, size in ((32, 256), (16, 256), (8, 64), (5, 77)):
        scale = size / feat
        lo, hi = (scale - 1.0) / 2.0, (feat - 1.0) * scale + (scale - 1.0) / 2.0
        want = torch.tensor([[lo, lo, 1.0], [lo, hi, 1.0], [hi, lo, 1.0], [hi, hi, 1.0]])
        assert torch.equal(_corner_coords(feat, size, "cpu", torch.float32), want)
    coords = torch.rand(2, 7, 3)
    assert torch.equal(pseudo_lines(coords, 0.3), pseudo_lines(coords, torch.tensor(0.3)))


def test_causal_masks_are_kept_on_their_device():
    from cvd_tpu_torch.models.motion import causal_temporal_mask, device_temporal_mask

    a = device_temporal_mask("causal", 4, "cpu")
    assert a is device_temporal_mask("causal", 4, "cpu")
    assert torch.equal(a, causal_temporal_mask("causal", 4))
    assert device_temporal_mask("causal", 5, "cpu") is not a


# ------------------------------------------------------------------ the CLI

def test_inference_advanced_cli_takes_step_chunk(tmp_path):
    """``--step_chunk 2`` end to end on the CPU: the videos of the run
    without it, bit for bit, written as without it."""
    from test_torch_advanced import _cli_args

    from cvd_tpu_torch.cli import inference_advanced

    base = inference_advanced.main(_cli_args(tmp_path / "whole"))
    chunked = inference_advanced.main(_cli_args(tmp_path / "chunked", "--step_chunk", "2"))
    assert len(chunked) == len(base) == 2
    for idx, (a, b) in enumerate(zip(base, chunked)):
        assert b["videos"].shape == (4, 2, 64, 64, 3) and np.isfinite(b["videos"]).all()
        np.testing.assert_array_equal(a["videos"], b["videos"])
        assert len(b["unet_step_ms"]) == 3 and b["program"]["unet_calls"] == 3
        saved = np.load(tmp_path / "chunked" / "out" / f"0_{idx:04d}" / "videos.npy")
        assert saved.dtype == np.uint8 and saved.shape == (4, 2, 64, 64, 3)
    with pytest.raises(SystemExit):
        inference_advanced.main(_cli_args(tmp_path / "zero", "--step_chunk", "0"))

"""Sharded sampling of cvd_tpu_torch on the CPU: the meshes and shard ops of
``cvd_tpu_torch.parallel`` against cvd_tpu's (``cvd_tpu.parallel``, four
of the virtual CPU devices, Pallas kernels interpreted), and the samplers
sharded over four gloo processes against the port unsharded and against
cvd_tpu sharded.

The processes start as ``torchrun`` would start them
(``tests/torch_dist_worker.py``), each group under a time limit of its own,
on the meshes (rows, frames) = (4, 1), (2, 2) and (1, 4). Tolerances: the
shard ops in f32 to 1e-5 (only where a row's data lives differs); the
samplers' final latents to 1e-5 of max |latent| against the port
unsharded, bit for bit across ranks (every rank takes the DDIM step on the
same gathered noise prediction), and at >= 60 dB against cvd_tpu, the bar
of the other parity tests. The samplers' UNet runs in float64 here: in
float32 one sharded UNet call differs from the unsharded one by ~1e-6 of
max |eps| (other row counts in the CPU's products), and two DDIM steps at
guidance 8.5 amplify that to ~6e-5 of max |latent|, above the bar.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

torch.set_num_threads(1)

MESHES = [(4, 1), (2, 2), (1, 4)]
Fr, S, IMG = 4, 16, 128   # frames, latent size, pixels: the top level's 16x16 grid


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Group:
    """``world`` worker processes with torchrun's environment, started at
    once; ``results()`` waits for them (killed after ``seconds``)."""

    def __init__(self, mode, world, tmp_path, spec, seconds):
        self.mode, self.seconds, self.procs, self.outs = mode, seconds, [], []
        inp = tmp_path / f"{mode}_in.pt"
        torch.save(spec, inp)
        port = _free_port()
        for rank in range(world):
            out = tmp_path / f"{mode}_rank{rank}" / "out.pt"
            out.parent.mkdir(parents=True)
            env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1")
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), mode, str(out),
                 str(inp)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
            self.outs.append(out)

    def results(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.seconds)[0])
        except subprocess.TimeoutExpired:
            pytest.fail(f"{self.mode}: the process group did not finish within "
                        f"{self.seconds} s")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(self.procs, logs):
            assert p.returncode == 0, log[-3000:]
        return [torch.load(o, weights_only=False) for o in self.outs]


def _fake_mesh(rows, frames, rank=0):
    """A port Mesh without process groups (shapes and coordinates only)."""
    from cvd_tpu_torch.parallel.mesh import Mesh

    return Mesh(("rows", "frames"), {"rows": rows, "frames": frames},
                {"rows": rank // frames, "frames": rank % frames}, rank,
                torch.device("cpu"), {})


# ------------------------------------------------------------ 1. the meshes

def test_inference_mesh_shapes_and_checks_match_cvd_tpu():
    from cvd_tpu.parallel import create_mesh as jax_create_mesh
    from cvd_tpu.parallel import inference_mesh as jax_inference_mesh
    from cvd_tpu.parallel import shard_ops as jso

    from cvd_tpu_torch.parallel import inference_shape
    from cvd_tpu_torch.parallel import shard_ops as so
    from cvd_tpu_torch.parallel.mesh import Mesh

    for n in range(1, 9):
        for rows in (2, 4):
            want = jax_inference_mesh(n, rows=rows).shape
            assert inference_shape(n, rows) == (want["rows"], want["frames"]), (n, rows)
    data = Mesh(("data",), {"data": 4}, {"data": 0}, 0, torch.device("cpu"), {})
    pairs = [(_fake_mesh(r, c), jax_create_mesh((r, c), ("rows", "frames"),
                                                devices=jax.devices()[:r * c]))
             for r, c in ((4, 1), (2, 2), (1, 4), (4, 2), (2, 4), (1, 1))]
    pairs += [(data, jax_create_mesh(axis_names=("data",), devices=jax.devices()[:4])),
              (None, None)]
    for mine, theirs in pairs:
        assert so.flat_batch_axes(mine) == jso.flat_batch_axes(theirs)
        for B in range(1, 13):
            for F in (1, 2, 3, 4, 6, 8, 16):
                assert so.mesh_ok_for_kernels(mine, B, F) == \
                    jso.mesh_ok_for_kernels(theirs, B, F), (mine, B, F)
                assert so.temporal_mesh_ok(mine, B, F) == \
                    jso.temporal_mesh_ok(theirs, B, F), (mine, B, F)


@pytest.mark.parametrize("shape", MESHES)
def test_block_rows_and_their_gathered_positions(shape):
    """Every rank's block rows, gathered over its rows group, hold every
    same-frame partner, at the positions ``gathered_rows`` names."""
    from cvd_tpu_torch.parallel import shard_ops as so

    R, C = shape
    Bv, F = 8, 8
    glob = torch.arange(Bv * F)
    every = []
    for rank in range(R * C):
        mesh = _fake_mesh(R, C, rank)
        rows = so.global_rows(mesh, Bv // R, F // C, "cpu")
        assert torch.equal(rows, so.local_rows(glob, mesh, F))
        every.append(rows)
        # the rows group's blocks, in rows order, as the all-gather stacks them
        gathered = torch.cat([so.global_rows(_fake_mesh(R, C, r * C + mesh.coords["frames"]),
                                             Bv // R, F // C, "cpu") for r in range(R)])
        partner = (rows + (Bv // 2) * F) % (Bv * F)
        assert torch.equal(gathered[so.gathered_rows(partner, mesh, Bv // R, F // C)], partner)
    assert sorted(torch.cat(every).tolist()) == glob.tolist()


@pytest.mark.parametrize("shape", MESHES)
def test_constrain_and_shard_batch_take_each_ranks_block(shape):
    """``constrain`` splits the named leading dims over the mesh axes (its
    blocks, row-major over the ranks, tile the global tensor) and refuses a
    dim that does not split; ``shard_batch`` takes every tensor's block."""
    from cvd_tpu_torch.parallel.mesh import constrain, shard_batch

    R, C = shape
    x = torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    blocks = [constrain(x, _fake_mesh(R, C, rank), "rows", "frames") for rank in range(R * C)]
    assert all(b.shape == (4 // R, 8 // C, 3) for b in blocks)
    rows = [torch.cat(blocks[r * C:(r + 1) * C], dim=1) for r in range(R)]
    assert torch.equal(torch.cat(rows, dim=0), x)
    assert constrain(x, None, "rows") is x
    with pytest.raises(ValueError, match="does not split"):
        constrain(x[:3], _fake_mesh(4, 1), "rows")
    got = shard_batch({"a": x, "b": [x[:, 0]]}, _fake_mesh(R, C, R * C - 1), "rows")
    assert torch.equal(got["a"], x[4 - 4 // R:]) and torch.equal(got["b"][0], x[4 - 4 // R:, 0])


# ------------------------------------------------------------ 2. the shard ops

def _op_cases():
    """Global f32 inputs (numpy seeds) of each shard-op case."""
    from cvd_tpu.geometry.epipolar_mask import epipolar_lines, lines_and_band, pixel_grid_coords
    from cvd_tpu.models.motion import causal_temporal_mask
    from cvd_tpu.pipelines.advanced import random_pairing

    from cvd_tpu_torch.pipelines.advanced import partner_rows

    cases = {}
    rng = np.random.default_rng(0)
    B, N, F, H = 4, 128, 8, 2
    for name, mask in (("temporal", None), ("temporal_causal", causal_temporal_mask("causal", F))):
        q, k, v = (rng.standard_normal((B, N, F, 32)).astype(np.float32) for _ in range(3))
        cases[name] = dict(kind="temporal", q=q, k=k, v=v, heads=H,
                           mask=None if mask is None else np.asarray(mask))
    feat, Fw = 16, 4
    pairing = np.array(random_pairing(jax.random.key(4), 4))
    for name, Bv in (("epi_half_swap", 4), ("epi_4view", 8)):
        rows = Bv * Fw
        q, k, v = (rng.standard_normal((rows, feat * feat, 32)).astype(np.float32)
                   for _ in range(3))
        F_mats = jnp.asarray(rng.standard_normal((rows, 3, 3)) * 1e-3, jnp.float32)
        coords = pixel_grid_coords(feat, 256)
        lines, band, alpha = lines_and_band(epipolar_lines(F_mats, coords), feat, 256)
        route = ((np.arange(rows) + rows // 2) % rows if Bv == 4
                 else partner_rows(torch.from_numpy(pairing).long(), Fw).numpy())
        cases[name] = dict(kind="epi", q=q, k=k, v=v, lines=np.asarray(lines),
                           coords=np.asarray(coords[:, :2].T), band=np.asarray(band),
                           alpha=np.asarray(alpha), heads=H, kv_index=route.astype(np.int32),
                           video_length=Fw)
        cases[name.replace("epi", "partner")] = dict(kind="partner", x=q, kv_index=cases[name][
            "kv_index"], video_length=Fw)
    cases["extended"] = dict(kind="extended", x=cases["epi_half_swap"]["q"], video_length=Fw)
    cases["spatial"] = dict(kind="spatial", q=cases["epi_4view"]["q"], k=cases["epi_4view"]["k"],
                            v=cases["epi_4view"]["v"], heads=H, video_length=Fw)
    return cases


def _port_unsharded(case):
    from cvd_tpu_torch.models.epi import gather_partner_tokens
    from cvd_tpu_torch.ops.epi_flash import epi_flash_attention, flash_attention
    from cvd_tpu_torch.ops.temporal_attn import temporal_flash_attention
    from cvd_tpu_torch.parallel.shard_ops import extended_context

    c = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in case.items()}
    if c["kind"] == "temporal":
        return temporal_flash_attention(c["q"], c["k"], c["v"], c["mask"], heads=c["heads"])
    if c["kind"] == "epi":
        return epi_flash_attention(c["q"], c["k"], c["v"], c["lines"], c["coords"], c["band"],
                                   c["alpha"], heads=c["heads"], kv_index=c["kv_index"])
    if c["kind"] == "spatial":
        return flash_attention(c["q"], c["k"], c["v"], heads=c["heads"])
    if c["kind"] == "partner":
        return gather_partner_tokens(c["x"], c["kv_index"])
    return extended_context(c["x"], None, 1)


def _cvd_tpu_sharded(case, shape):
    """cvd_tpu's shard_map op on the mesh ``shape`` of four virtual devices."""
    from cvd_tpu.parallel import create_mesh
    from cvd_tpu.parallel import shard_ops as jso

    mesh = create_mesh(shape, ("rows", "frames"), devices=jax.devices()[:4])
    c = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in case.items()}
    if c["kind"] == "temporal":
        return jax.jit(lambda q, k, v: jso.sharded_temporal_flash(
            q, k, v, c["mask"], c["heads"], mesh))(c["q"], c["k"], c["v"])
    return jax.jit(lambda q, k, v: jso.sharded_epi_flash(
        q, k, v, c["lines"], c["coords"], c["band"], c["alpha"], c["heads"], c["kv_index"],
        c["video_length"], mesh))(c["q"], c["k"], c["v"])


def test_shard_ops_match_unsharded_and_cvd_tpu(tmp_path):
    """``sharded_temporal_flash`` (no mask, causal), ``sharded_epi_flash``
    (the half swap with one video per rows shard on (4, 1) and two or four
    on the others; a 4-view matching over interleaved CFG rows, B / R > 1
    with Cf > 1 on (2, 2)), the plain path's partner gather, extended
    attention's context and the spatial op, on four gloo processes per
    mesh, gathered back: equal to the port's unsharded op and to cvd_tpu's
    shard_map op within 1e-5."""
    cases = _op_cases()
    spec = {"meshes": MESHES,
            "cases": {n: {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                          for k, v in c.items()} for n, c in cases.items()}}
    group = _Group("mesh_ops", 4, tmp_path, spec, seconds=180)
    theirs = {(shape, n): np.asarray(_cvd_tpu_sharded(c, shape))
              for shape in MESHES for n, c in cases.items() if c["kind"] in ("temporal", "epi")}
    ranks = group.results()
    for n, case in cases.items():
        want = _port_unsharded(case).numpy()
        for shape in MESHES:
            got = ranks[0][(shape, n)]
            for r in ranks[1:]:
                assert torch.equal(r[(shape, n)], got), (n, shape)
            got = got.numpy()
            assert got.shape == want.shape, (n, shape)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"{n} {shape}")
            if (shape, n) in theirs:
                np.testing.assert_allclose(got, theirs[(shape, n)], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{n} {shape} vs cvd_tpu")


# ------------------------------------------------------------ 3, 4. the samplers

STEPS, MULTI, ACC, V = 2, 2, 2, 4


def _jax_bundle():
    """cvd_tpu's tiny bundle (fast init) with perturbed UNet and pose-encoder
    params, so that the zero-initialized epi and pose-merge layers take part."""
    from cvd_tpu.pipelines.common import PipelineModules as JaxModules
    from test_torch_slice import _perturbed
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    base = JaxModules.create(unet_config=TINY_UNET, vae_config=TINY_VAE, clip_config=TINY_CLIP,
                             latent_size=S, video_length=Fr, fast_init=True)
    return dataclasses.replace(
        base, unet_params=jax.tree_util.tree_map(jnp.asarray, _perturbed(base.unet_params, 0)),
        pose_encoder_params=_perturbed(base.pose_encoder_params, 1))


def _sampler_inputs():
    """-> (the inputs of every sampler case, cvd_tpu's rng key of the N-view
    cases); tensors as numpy."""
    from cvd_tpu.geometry.plucker import ray_condition
    from cvd_tpu.geometry.trajectories import circle_trajectory, default_intrinsics
    from cvd_tpu.io.tokenizer import HashTokenizer
    from test_torch_advanced import _replay_reference_draws

    rng = np.random.default_rng(2)
    tok = HashTokenizer()
    ids, neg = tok(["a sharded scene"]), tok(["blurry"])
    common = dict(prompt_ids=ids, negative_ids=neg, num_inference_steps=STEPS,
                  guidance_scale=8.5)

    def two_view(frames):
        return dict(common, plucker=rng.standard_normal((2, frames, IMG, IMG, 6)).astype(
            np.float32), F_mats=(rng.standard_normal((2, frames, 3, 3)) * 1e-3).astype(
            np.float32), latents=rng.standard_normal((2, frames, S, S, 4)).astype(np.float32))

    simple = two_view(Fr)
    cases = {
        "simple": dict(pipeline="simple", call=simple),
        # 6 frames as two windows of 4 overlapping by 2: the frames shard within a window
        "simple_multidiff": dict(pipeline="simple", call=dict(
            two_view(6), multidiff_total_steps=2, multidiff_overlaps=2)),
        "simple_extended": dict(pipeline="simple", bundle="extended", call=simple),
    }
    c2ws = circle_trajectory(V, Fr, camera_dist=0.3)
    K = default_intrinsics(V, Fr, IMG, IMG)
    intr = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], -1).astype(np.float32)
    plucker = np.asarray(ray_condition(intr[None], c2ws[None].astype(np.float32), IMG, IMG)[0])
    lat0 = rng.standard_normal((V, Fr, S, S, 4)).astype(np.float32)
    key = jax.random.key(11)
    partners, noises = _replay_reference_draws(key, V, lat0.shape, STEPS, MULTI, ACC)
    nview = dict(common, plucker=plucker.reshape(V, Fr, IMG, IMG, 6).astype(np.float32),
                 c2w=c2ws.astype(np.float32), K_mats=K.astype(np.float32), latents=lat0,
                 multistep=MULTI, accumulate_step=ACC)
    for name, batched in (("nview_loop", False), ("nview_batched", True)):
        cases[name] = dict(pipeline="advanced", batched=batched, call=nview,
                           partners=[p.astype(np.int64) for p in partners], noises=noises)
    for c in cases.values():
        c["F_mat_size"] = IMG
    return cases, key


def _torch_case(case):
    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x.copy())
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x

    return conv(case)


@pytest.fixture(scope="module")
def samplers(tmp_path_factory):
    """Every sampler case on every mesh over four gloo processes, the port
    unsharded (shared out over the same processes), and cvd_tpu sharded over
    ``inference_mesh(4)`` on the 2-view and the N-view loop case.
    -> (cases, ranks' results, unsharded, cvd_tpu)."""
    from cvd_tpu.parallel import inference_mesh
    from cvd_tpu.pipelines.advanced import AdvancedPipeline as JaxAdvanced
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxSimple
    from test_torch_slice import _port_modules

    jm = _jax_bundle()
    port = _port_modules(jm)
    state = {n: getattr(port, n).state_dict() for n in ("unet", "vae", "clip", "pose_encoder")}
    cases, key = _sampler_inputs()
    tcases = {n: _torch_case(c) for n, c in cases.items()}
    group = _Group("mesh_samplers", 4, tmp_path_factory.mktemp("samplers"),
                   {"bundle": state, "meshes": MESHES, "cases": tcases}, seconds=420)
    mesh = inference_mesh(4)
    assert dict(mesh.shape) == {"rows": 4, "frames": 1}
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in cases["simple"]["call"].items()}
    theirs = {"simple": np.asarray(JaxSimple(jm, F_mat_size=IMG, rand_slope_ff=False,
                                             use_flash_kernel=False, mesh=mesh)(
        j["prompt_ids"], j["negative_ids"], j["plucker"], j["F_mats"],
        num_inference_steps=STEPS, guidance_scale=8.5, rng=jax.random.key(0),
        latents=j["latents"], decode=False))}
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in cases["nview_loop"]["call"].items()}
    theirs["nview_loop"] = np.asarray(JaxAdvanced(
        jm, F_mat_size=IMG, rand_slope_ff=False, fix_firstframe=True, use_flash_kernel=False,
        mesh=mesh)(j["prompt_ids"], j["negative_ids"], j["plucker"], c2w=j["c2w"],
                   K_mats=j["K_mats"], num_inference_steps=STEPS, guidance_scale=8.5,
                   multistep=MULTI, accumulate_step=ACC, rng=key, latents=j["latents"],
                   decode=False))
    ranks = group.results()
    unsharded = {n: r[("unsharded", n)].numpy() for r in ranks for n in cases
                 if ("unsharded", n) in r}
    assert sorted(unsharded) == sorted(cases)
    return cases, ranks, unsharded, theirs


@pytest.mark.parametrize("name", ["simple", "simple_multidiff", "simple_extended", "nview_loop",
                                  "nview_batched"])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_sampler_equals_unsharded(samplers, name, shape):
    """The port's sampler sharded over four gloo processes: the final latents
    within 1e-5 of max |latent| of the unsharded run, bit for bit on every
    rank (the 2-view sampler, with multidiff windows and with extended
    attention; the 4-view sampler with fix_firstframe as a loop and with
    accumulate_batched)."""
    _, ranks, unsharded, _ = samplers
    got = ranks[0][(shape, name)]
    for r in ranks[1:]:
        assert torch.equal(r[(shape, name)], got)
    want = unsharded[name]
    assert got.shape == want.shape and np.isfinite(want).all()
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), f"{name} {shape}: max |error| {err}"


@pytest.mark.parametrize("name", ["simple", "nview_loop"])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_sampler_matches_cvd_tpu_sharded(samplers, name, shape):
    """The port sharded on each mesh against cvd_tpu's pipeline sharded over
    ``inference_mesh(4)`` (the same weights through io/from_flax, latents,
    horizontal first-frame lines and replayed pairings): >= 60 dB."""
    _, ranks, _, theirs = samplers
    got, want = ranks[0][(shape, name)].numpy(), theirs[name]
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    assert snr >= 60.0, f"{name} {shape}: latent SNR {snr:.1f} dB < 60 dB"


# ------------------------------------------------------------ 5. the CLIs

ASSETS = os.path.join(ROOT, "assets")
CLI_ARGS = {
    "inference": ["--random-weights", "--image_height", "64", "--image_width", "64",
                  "--video_length", "2", "--num_inference_steps", "2",
                  "--caption_file", os.path.join(ASSETS, "example_prompts.json"),
                  "--use_negative_prompt",
                  "--pose_file_0", os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
                  "--pose_file_1", os.path.join(ASSETS, "pose_files", "example_arc.txt")],
    "inference_advanced": ["--random-weights", "--view_num", "4", "--video_length", "2",
                           "--image_height", "64", "--image_width", "64",
                           "--num_inference_steps", "2", "--multistep", "2",
                           "--accumulate_step", "2", "--fix_firstframe",
                           "--caption_file", os.path.join(ASSETS, "example_prompts.json"),
                           "--use_negative_prompt"],
}


def _cli(name):
    import importlib

    return importlib.import_module(f"cvd_tpu_torch.cli.{name}")


def _videos(root):
    return {os.path.relpath(d, root): np.load(os.path.join(d, "videos.npy"))
            for d, _, files in os.walk(root) if "videos.npy" in files}


def test_sharded_clis_on_two_gloo_processes(tmp_path):
    """Both CLIs with ``--sharded --device cpu`` over two gloo processes (the
    mesh (2, 1)): rank 0 writes the unsharded run's videos, rank 1 writes
    nothing and holds no videos. The bar is float32's summation order over
    other row counts: one uint8 step for the 2-view CLI; >= 40 dB PSNR for
    the N-view CLI, whose multistep re-noising amplifies that noise to
    ~5e-3 of max |latent| (zero in float64: the sampler tests above hold
    the same path to 1e-5)."""
    group = _Group("mesh_clis", 2, tmp_path, CLI_ARGS, seconds=240)
    want = {}
    for name, argv in CLI_ARGS.items():
        args = _cli(name).build_parser().parse_args(
            argv + ["--device", "cpu", "--out_root", str(tmp_path / "unsharded" / name)])
        _cli(name).main(args)
        want[name] = _videos(tmp_path / "unsharded" / name)
    r0, r1 = group.results()
    for name in CLI_ARGS:
        got = _videos(tmp_path / "mesh_clis_rank0" / name)
        assert sorted(got) == sorted(want[name]) and len(got) == 2, name
        for sub, v in got.items():
            assert v.shape == want[name][sub].shape, (name, sub)
            diff = np.abs(v.astype(int) - want[name][sub].astype(int))
            psnr = 10 * np.log10(255.0 ** 2 / max(np.mean(diff ** 2), 1e-12))
            if name == "inference":
                assert diff.max() <= 1, (name, sub, diff.max())
            else:
                assert psnr >= 40.0, (name, sub, psnr)
        assert not (tmp_path / "mesh_clis_rank1" / name).exists()
        assert all(rec["videos"] is None for rec in r1[name])
        assert all(rec["videos"] is not None for rec in r0[name])


@pytest.mark.parametrize("name", ["inference", "inference_advanced"])
def test_sharded_cli_refusals(tmp_path, monkeypatch, name):
    """Without torchrun's environment --sharded raises naming torchrun; --pab
    with --sharded is refused in cvd_tpu's words; a mesh that does not
    divide the rows raises before the build, naming the mesh and the shape.
    Nothing is written in any case."""
    import torch.distributed as dist

    from cvd_tpu_torch.parallel import mesh as port_mesh
    from cvd_tpu_torch.parallel.mesh import TORCHRUN_ENV

    cli = _cli(name)
    out = tmp_path / "out"

    def args(*extra):
        return cli.build_parser().parse_args(CLI_ARGS[name] + ["--device", "cpu", "--out_root",
                                                               str(out), *extra])

    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
        cli.main(args("--sharded"))
    with pytest.raises(SystemExit, match=r"--pab \+ --sharded is not validated; pick one"):
        cli.main(args("--sharded", "--pab"))
    # a world of one whose mesh claims 3 rows: 3 divides neither 4 nor 8 rows
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setattr(port_mesh, "inference_mesh", lambda n: _fake_mesh(3, 1))
    with pytest.raises(ValueError, match=r"mesh \{'rows': 3, 'frames': 1\} does not divide"):
        cli.main(args("--sharded"))
    assert not dist.is_initialized()      # the group the call made is gone
    assert not out.exists()


def test_world_of_one_sharded_cli_is_the_unsharded_run_bit_for_bit(tmp_path, monkeypatch):
    """A world of one shards nothing: --sharded gives the unsharded videos
    bit for bit, and the process group is destroyed at the end."""
    import torch.distributed as dist

    cli = _cli("inference")
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    runs = [cli.main(cli.build_parser().parse_args(
        CLI_ARGS["inference"] + ["--device", "cpu", "--out_root", str(tmp_path / str(i)), *x]))
        for i, x in enumerate(([], ["--sharded"]))]
    assert not dist.is_initialized()
    for a, b in zip(*runs):
        assert np.array_equal(a["videos"], b["videos"])

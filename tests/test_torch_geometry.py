"""cvd_tpu_torch geometry and pose-file data against cvd_tpu.

The port keeps host geometry in numpy and the epipolar-mask math in torch;
the JAX side computes in jnp (precision="highest"). Tolerance: f32
atol = rtol = 1e-5, 1e-4 where f32 values reach ~1e2 (pixel coordinates).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
POSE_0 = "assets/pose_files/example_dolly.txt"
POSE_1 = "assets/pose_files/example_arc.txt"


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("feat", [8, 16, 32])
def test_pixel_grid_coords(feat):
    from cvd_tpu.geometry.epipolar_mask import pixel_grid_coords as jpg
    from cvd_tpu_torch.geometry.epipolar_mask import pixel_grid_coords

    np.testing.assert_array_equal(pixel_grid_coords(feat, 256).numpy(), np.asarray(jpg(feat, 256)))


def _lines(seed, feat=16):
    rng = np.random.default_rng(seed)
    F = (rng.standard_normal((3, 3, 3)) * 1e-3).astype(np.float32)
    from cvd_tpu.geometry.epipolar_mask import pixel_grid_coords

    return F, np.asarray(pixel_grid_coords(feat, 256))


def test_epipolar_lines():
    from cvd_tpu.geometry.epipolar_mask import epipolar_lines as jel
    from cvd_tpu_torch.geometry.epipolar_mask import epipolar_lines

    F, coords = _lines(0)
    np.testing.assert_allclose(epipolar_lines(t(F), t(coords)).numpy(),
                               np.asarray(jel(jnp.asarray(F), jnp.asarray(coords))), **TOL)


@pytest.mark.parametrize("slope", [None, 0.3, 2.5])
def test_pseudo_lines(slope):
    from cvd_tpu.geometry.epipolar_mask import pseudo_lines as jpl
    from cvd_tpu_torch.geometry.epipolar_mask import pseudo_lines

    _, coords = _lines(1)
    js = None if slope is None else jnp.asarray([slope], jnp.float32)
    ps = None if slope is None else torch.tensor([slope])
    np.testing.assert_allclose(pseudo_lines(t(coords)[None], ps).numpy(),
                               np.asarray(jpl(jnp.asarray(coords)[None], js)),
                               rtol=1e-5, atol=1e-4)


def test_lines_and_band_and_bias():
    from cvd_tpu.geometry import epipolar_mask as J
    from cvd_tpu_torch.geometry import epipolar_mask as P

    F, coords = _lines(2)
    jl = J.epipolar_lines(jnp.asarray(F), jnp.asarray(coords))
    pl = P.epipolar_lines(t(F), t(coords))
    for got, want in zip(P.lines_and_band(pl, 16, 256), J.lines_and_band(jl, 16, 256)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = P.epipolar_attn_bias_from_lines(pl, t(coords), 16, 256)
    want = J.epipolar_attn_bias_from_lines(jl, jnp.asarray(coords), 16, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def _rotations(rng, n):
    """n random proper rotations [n, 3, 3] (QR of a Gaussian, det +1)."""
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


@pytest.mark.parametrize("case", ["identity", "rotated", "off_centre", "h_ne_w", "b2_v3"])
def test_ray_condition(case):
    """The [o]x R algebra of the port's closed form against the JAX
    package's generic rays: rotations, origins, intrinsics, grid, batch."""
    from cvd_tpu.geometry.plucker import ray_condition as jrc
    from cvd_tpu_torch.geometry.plucker import ray_condition

    rng = np.random.default_rng(3)
    B, V, H, W = {"h_ne_w": (1, 2, 24, 40), "b2_v3": (2, 3, 32, 32)}.get(case, (1, 2, 32, 32))
    K = np.tile(np.array([40.0, 42.0, 16.0, 15.0], np.float32), (B, V, 1))
    if case in ("off_centre", "b2_v3"):
        K = np.stack([rng.uniform(25, 60, (B, V)), rng.uniform(30, 70, (B, V)),
                      rng.uniform(-4, 10, (B, V)), rng.uniform(20, 30, (B, V))],
                     -1).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    c2w[..., :3, 3] = rng.standard_normal((B, V, 3)).astype(np.float32)
    if case != "identity":
        c2w[..., :3, :3] = _rotations(rng, B * V).reshape(B, V, 3, 3)
        c2w[..., :3, 3] *= 3
    got = ray_condition(K, c2w, H, W)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    want = jrc(jnp.asarray(K), jnp.asarray(c2w), H, W)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _generic_rays(intr, c2w, H, W):
    """The port's former generic formulation: [V, HW, 3] directions,
    norm, einsum against R, cross with the broadcast origin, concat."""
    j = np.arange(H, dtype=np.float32) + 0.5
    i = np.arange(W, dtype=np.float32) + 0.5
    jj, ii = np.meshgrid(j, i, indexing="ij")
    ii, jj = ii.reshape(1, H * W), jj.reshape(1, H * W)
    fx, fy, cx, cy = [intr[:, k:k + 1] for k in range(4)]
    d = np.stack([(ii - cx) / fx, (jj - cy) / fy, np.ones_like(ii - cx)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = np.einsum("vnk,vjk->vnj", d, c2w[:, :3, :3])
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape)
    return np.concatenate([np.cross(rays_o, rays_d), rays_d], -1).reshape(-1, H, W, 6)


@pytest.mark.parametrize("frames,size", [(4, 64), (16, 256)])
def test_val_pose_folded_plucker(frames, size):
    """The folded sample's rays, computed from the folded cameras: a
    C-contiguous float32 array that torch takes as is, equal to the
    unfolded clip's rays indexed by the fold."""
    from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded, load_pair_cameras
    from cvd_tpu_torch.geometry.folding import fold_indices

    got = ValRealEstate10KPoseFolded(["a", "b"], POSE_0, POSE_1, sample_n_frames=frames,
                                     sample_size=size)[1]["plucker_embedding"]
    assert type(got) is np.ndarray and got.dtype == np.float32 and got.flags.c_contiguous
    assert torch.from_numpy(got).shape == (2 * frames, size, size, 6)
    c2w, _, intr = load_pair_cameras(POSE_0, POSE_1, size, n_frames=frames)
    want = _generic_rays(intr.astype(np.float32), c2w.astype(np.float32), size, size)
    np.testing.assert_allclose(got, want[fold_indices(frames)], **TOL)


def test_folded_pair_F_mats():
    from cvd_tpu.data.validation import load_pair_cameras
    from cvd_tpu.geometry.folding import folded_pair_F_mats as jf
    from cvd_tpu_torch.geometry.folding import folded_pair_F_mats

    c2w, K, _ = load_pair_cameras(POSE_0, POSE_1, 256, n_frames=8)
    np.testing.assert_allclose(folded_pair_F_mats(c2w, K, 8), np.asarray(jf(c2w, K, 8)),
                               **TOL)


@pytest.mark.parametrize("frames,size", [(4, 64), (16, 256)])
def test_val_realestate10k_pose_folded(frames, size):
    from cvd_tpu.data.validation import ValRealEstate10KPoseFolded as JV
    from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded as PV

    kw = dict(validation_prompts=["a", "b"], validation_negative_prompts=["n", "m"],
              pose_file_0=POSE_0, pose_file_1=POSE_1, sample_n_frames=frames,
              sample_size=size)
    got, want = PV(**kw)[1], JV(**kw)[1]
    assert set(got) == set(want)
    assert got["plucker_embedding"].shape == (2 * frames, size, size, 6)
    assert got["F_mats"].shape == (2 * frames, 3, 3)
    for key in ("plucker_embedding", "F_mats", "ret_c2w", "ret_K_mats"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert got["validation_prompt"] == "b" and got["validation_negative_prompt"] == "m"

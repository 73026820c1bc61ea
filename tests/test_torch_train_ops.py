"""Backward parity: the port's ops under torch autograd (their plain
versions, which CPU tensors take) against ``jax.vjp`` of the JAX entry
points, whose custom_vjps run the Pallas backward kernels in interpret mode
off-TPU (epi_flash._bwd_kernel, temporal_attn._bwd_kernel) or ``jax.vjp``
of their reference (group_norm, layer_norm_matmul with force_kernel=True).

The CUDA backward kernels K6/K7 run only on the card; ``chip_smoke.py``
holds them against autograd of these plain versions there. Tolerance: f32,
1e-4 x max |ref| (summation order only).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _epi_inputs(seed, feat=16, heads=2, dim=32, B=4):
    from cvd_tpu.geometry.epipolar_mask import epipolar_lines, lines_and_band, pixel_grid_coords

    rng = np.random.default_rng(seed)
    N, C = feat * feat, heads * dim
    q, k, v, g = (rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(4))
    F_mats = (rng.standard_normal((B, 3, 3)) * 1e-3).astype(np.float32)
    coords = pixel_grid_coords(feat, 256)
    lines, band, alpha = lines_and_band(epipolar_lines(jnp.asarray(F_mats), coords), feat, 256)
    geom = (np.asarray(lines), np.asarray(coords[:, :2].T), np.asarray(band), np.asarray(alpha))
    return q, k, v, g, geom


@pytest.mark.parametrize("routed", [False, True])
def test_epi_flash_attention_backward_matches_jax(routed):
    """K1 + K6: dq/dk/dv with the in-tile epipolar bias; routed dk/dv are
    scatter-added back to the source rows."""
    from cvd_tpu.ops.epi_flash import epi_flash_attention as jax_epi
    from cvd_tpu_torch.ops.epi_flash import epi_flash_attention

    q, k, v, g, geom = _epi_inputs(seed=11)
    route = np.array([2, 3, 0, 1], np.int32) if routed else None
    jroute = None if route is None else jnp.asarray(route)
    _, vjp = jax.vjp(lambda a, b, c: jax_epi(a, b, c, *(jnp.asarray(x) for x in geom),
                                             heads=2, kv_index=jroute),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    xs = [t(a, True) for a in (q, k, v)]
    out = epi_flash_attention(*xs, *(t(x) for x in geom), heads=2,
                              kv_index=None if route is None else t(route))
    got = torch.autograd.grad(out, xs, t(g))
    for gi, wi in zip(got, want):
        close(gi.numpy(), wi)


def _ragged_inputs(seed, B=4, Lq=200, Lk=150, heads=2, dim=40):
    """q [B, Lq, C], k/v [B, Lk, C] at head_dim 40 with lengths that fill no
    64-row tile, and epipolar geometry off any pixel grid."""
    rng = np.random.default_rng(seed)
    C = heads * dim
    q, g = (rng.standard_normal((B, Lq, C)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Lk, C)).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0, 2 * np.pi, (B, Lq))
    off = rng.uniform(0, 256, (B, Lq))
    lines = np.stack([np.cos(ang), np.sin(ang), -off * (np.cos(ang) + np.sin(ang))],
                     -1).astype(np.float32)
    geom = (lines, rng.uniform(0, 256, (2, Lk)).astype(np.float32),
            rng.uniform(2, 10, B).astype(np.float32), rng.uniform(0.1, 0.6, B).astype(np.float32))
    return q, k, v, g, geom


@pytest.mark.parametrize("route", [None, [0, 0, 2, 2], [3, 3, 3, 1]])
def test_epi_flash_backward_plain_matches_jax_ragged_and_shared_rows(route):
    """K6's plain version (``_plain_bwd``, what the CUDA kernel is held
    against on the card) vs ``jax.vjp`` of the JAX op at head_dim 40, Lq 200 /
    Lk 150, with a kv_index that routes several query rows to one source row
    and none to others: those rows' dk/dv are sums, and zeros."""
    from cvd_tpu.ops.epi_flash import epi_flash_attention as jax_epi
    from cvd_tpu_torch.ops.epi_flash import _plain_bwd

    q, k, v, g, geom = _ragged_inputs(seed=19)
    jroute = None if route is None else jnp.asarray(route, jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: jax_epi(a, b, c, *(jnp.asarray(x) for x in geom),
                                             heads=2, kv_index=jroute),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    idx = None if route is None else t(np.array(route, np.int32))
    got = _plain_bwd(t(q), t(k), t(v), tuple(t(x) for x in geom), idx, 2, t(g))
    for gi, wi in zip(got, want):
        close(gi.numpy(), wi)
    if route is not None:
        unrouted = sorted(set(range(4)) - set(route))
        assert not got[1][unrouted].any() and not got[2][unrouted].any()


def test_flash_backward_plain_matches_jax_ragged():
    """K6 without bias at head_dim 40, Lq 200 / Lk 150."""
    from cvd_tpu.ops.epi_flash import flash_attention as jax_flash
    from cvd_tpu_torch.ops.epi_flash import _plain_bwd

    q, k, v, g, _ = _ragged_inputs(seed=20)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, heads=2),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = _plain_bwd(t(q), t(k), t(v), None, None, 2, t(g))
    for gi, wi in zip(got, want):
        close(gi.numpy(), wi)


@pytest.mark.parametrize("dtype, dim", [(torch.bfloat16, 24), (torch.bfloat16, 72),
                                        (torch.float32, 100)])
def test_backward_kernel_refuses_a_head_dim_it_is_not_built_for(dtype, dim):
    """``_launch_bwd`` raises on a head_dim outside the bf16 kernels'
    instantiations, or wider than the f32 kernels' shared memory holds, before
    it builds or launches anything (so it raises here, without nvcc)."""
    from cvd_tpu_torch.ops import epi_flash

    x = torch.zeros(1, 64, 2 * dim, dtype=dtype)
    with pytest.raises(ValueError, match=f"head_dim {dim}"):
        epi_flash._launch_bwd(x, x, x, None, None, 2, x, torch.zeros(1, 2, 64), x)
    assert 40 in epi_flash._BWD_BF16_HEAD_DIMS and 160 in epi_flash._BWD_BF16_HEAD_DIMS
    epi_flash._check_bwd(torch.float32, 96)


def test_flash_attention_backward_matches_jax():
    """K2 + K6 without bias."""
    from cvd_tpu.ops.epi_flash import flash_attention as jax_flash
    from cvd_tpu_torch.ops.epi_flash import flash_attention

    rng = np.random.default_rng(12)
    q, k, v, g = (rng.standard_normal((2, 256, 32)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, heads=2),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    xs = [t(a, True) for a in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*xs, heads=2), xs, t(g))
    for gi, wi in zip(got, want):
        close(gi.numpy(), wi)


@pytest.mark.parametrize("mask_kind", ["", "causal"])
def test_temporal_attention_backward_matches_jax(mask_kind):
    """K3 + K7: per-pixel attention over frames, with and without a mask."""
    from cvd_tpu.models.motion import causal_temporal_mask as jax_mask
    from cvd_tpu.ops.temporal_attn import temporal_flash_attention as jax_temporal
    from cvd_tpu_torch.models.motion import causal_temporal_mask
    from cvd_tpu_torch.ops.temporal_attn import temporal_flash_attention

    rng = np.random.default_rng(13)
    q, k, v, g = (rng.standard_normal((2, 16, 8, 32)).astype(np.float32) for _ in range(4))
    jmask = jax_mask(mask_kind, 8) if mask_kind else None
    pmask = causal_temporal_mask(mask_kind, 8) if mask_kind else None
    _, vjp = jax.vjp(lambda a, b, c: jax_temporal(a, b, c, jmask, heads=4),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    xs = [t(a, True) for a in (q, k, v)]
    got = torch.autograd.grad(temporal_flash_attention(*xs, pmask, heads=4), xs, t(g))
    for gi, wi in zip(got, want):
        close(gi.numpy(), wi)


@pytest.mark.parametrize("case", ["F12", "F16 G24", "0 mask", "split views"])
def test_temporal_attention_backward_matches_jax_off_the_tile(case):
    """K3 + K7 away from 16 x 16 frames and contiguous inputs (the cases of
    ``test_torch_ops._temporal_case``): 12 frames, 24 key frames under an
    arbitrary mask, the one-key "0" mask, q/k/v as ``split`` views of one
    fused leaf (its gradient is the three gradients side by side)."""
    from cvd_tpu.ops.temporal_attn import temporal_flash_attention as jax_temporal
    from cvd_tpu_torch.ops.temporal_attn import temporal_flash_attention
    from test_torch_ops import _temporal_case

    q, k, v, mask, fused = _temporal_case(case, seed=41)
    g = np.random.default_rng(42).standard_normal(q.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_temporal(a, b, c, jmask, heads=4),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    pmask = None if mask is None else t(mask)
    if fused is not None:
        leaf = t(fused, True)
        out = temporal_flash_attention(*leaf.split(32, -1), pmask, heads=4)
        got = torch.autograd.grad(out, leaf, t(g))[0].split(32, -1)
    else:
        xs = [t(a, True) for a in (q, k, v)]
        got = torch.autograd.grad(temporal_flash_attention(*xs, pmask, heads=4), xs, t(g))
    for gi, wi in zip(got, want):
        assert gi.shape == wi.shape
        close(gi.numpy(), wi)
    if case == "0 mask":  # only key frame 0 is attended: dq is zero, dk too
        assert not got[0].any() and not got[1].any() and not got[2][:, :, 1:].any()


def test_temporal_backward_wrapper_takes_views_on_the_cpu():
    """``temporal_flash_attention_bwd`` with q/k/v as split views and a
    strided dO (a view of a wider tensor) equals autograd of the forward
    wrapper on contiguous copies."""
    from cvd_tpu_torch.ops import temporal_attn

    rng = np.random.default_rng(43)
    fused = t(rng.standard_normal((2, 8, 12, 96)).astype(np.float32))
    g = t(rng.standard_normal((2, 8, 12, 64)).astype(np.float32))[..., 32:]
    assert not g.is_contiguous()
    mask = t(rng.standard_normal((12, 12)).astype(np.float32))
    got = temporal_attn.temporal_flash_attention_bwd(*fused.split(32, -1), mask, 4, g)
    xs = [x.contiguous().requires_grad_() for x in fused.split(32, -1)]
    want = torch.autograd.grad(temporal_attn.temporal_flash_attention(*xs, mask, 4), xs,
                               g.contiguous())
    for gi, wi in zip(got, want):
        torch.testing.assert_close(gi, wi)
    assert temporal_attn.temporal_flash_attention_bwd.launches == 0


@pytest.mark.parametrize("arithmetic", ["bfloat16", "float32"])
def test_temporal_backward_bound_at_the_timed_shape(arithmetic):
    """K7 at B2 N1024 F16 C320 in bf16: 4 reads and 3 writes, 147 MB, 0.044
    ms by bytes whichever unit does the products."""
    from cvd_tpu_torch.ops import work

    flops, moved = work.temporal_bwd(2, 1024, 16, 320, 2)
    assert moved == 7 * 2 * 1024 * 16 * 320 * 2
    bound, by = work.bound_ms(flops, moved, arithmetic)
    assert by == "bytes" and bound == pytest.approx(0.0438, rel=5e-3)
    assert work.temporal_bwd(2, 1024, 16, 320, 2, has_mask=True) == (flops, moved + 16 * 16 * 4)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_backward_matches_jax(act):
    """K4: gradients of x, gamma and beta."""
    from cvd_tpu.ops.norms import group_norm as jax_gn
    from cvd_tpu_torch.ops.norms import group_norm

    rng = np.random.default_rng(14)
    x = (rng.standard_normal((4, 8, 8, 64)) * 3 + 1).astype(np.float32)
    gam, bet = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_gn(a, b, c, 32, eps=1e-6, act=act, force_kernel=True),
                     jnp.asarray(x), jnp.asarray(gam), jnp.asarray(bet))
    want = vjp(jnp.asarray(g))
    xs = [t(a, True) for a in (x, gam, bet)]
    got = torch.autograd.grad(group_norm(*xs, 32, eps=1e-6, act=act), xs, t(g))
    for gi, wi in zip(got, want):
        close(gi.numpy(), wi)


@pytest.mark.parametrize("n_proj", [1, 3])
def test_layer_norm_matmul_backward_matches_jax(n_proj):
    """K5: gradients of x, gamma, beta, every W_i and b_i (the folding is
    inside the forward, so they reach the unfolded parameters)."""
    from cvd_tpu.ops.ln_matmul import layer_norm_matmul as jax_lnmm
    from cvd_tpu_torch.ops.ln_matmul import layer_norm_matmul

    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    gam, bet = (rng.standard_normal(128).astype(np.float32) for _ in range(2))
    ws = [(rng.standard_normal((128, 128)) * 0.1).astype(np.float32) for _ in range(n_proj)]
    bs = [rng.standard_normal(128).astype(np.float32) for _ in range(n_proj)]
    g = rng.standard_normal((2, 64, 128 * n_proj)).astype(np.float32)

    def jfn(x_, g_, b_, ws_, bs_):
        return jnp.concatenate(jax_lnmm(x_, g_, b_, ws_, bs_, force_kernel=True), -1)

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(gam), jnp.asarray(bet),
                     [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    dx, dgam, dbet, dws, dbs = vjp(jnp.asarray(g))
    xs = [t(a, True) for a in (x, gam, bet)]
    pws = [t(w.T.copy(), True) for w in ws]
    pbs = [t(b, True) for b in bs]
    out = torch.cat(layer_norm_matmul(*xs, pws, pbs), -1)
    got = torch.autograd.grad(out, xs + pws + pbs, t(g))
    for gi, wi in zip(got[:3], (dx, dgam, dbet)):
        close(gi.numpy(), wi)
    for gi, wi in zip(got[3:3 + n_proj], dws):
        close(gi.numpy().T, wi)
    for gi, wi in zip(got[3 + n_proj:], dbs):
        close(gi.numpy(), wi)


def test_epi_geometry_gets_no_gradient():
    """norm_lines, band and alpha are geometry: zero cotangents in JAX, no
    gradient in the port (the reference detaches the mask)."""
    from cvd_tpu.ops.epi_flash import epi_flash_attention as jax_epi
    from cvd_tpu_torch.ops.epi_flash import epi_flash_attention

    q, k, v, g, (lines, coords, band, alpha) = _epi_inputs(seed=16)
    _, vjp = jax.vjp(lambda l_, b_, a_: jax_epi(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                l_, jnp.asarray(coords), b_, a_, heads=2),
                     jnp.asarray(lines), jnp.asarray(band), jnp.asarray(alpha))
    for cot in vjp(jnp.asarray(g)):
        assert not np.asarray(cot).any()
    geo = [t(lines, True), t(band, True), t(alpha, True)]
    qv = t(q, True)
    out = epi_flash_attention(qv, t(k), t(v), geo[0], t(coords), geo[1], geo[2], heads=2)
    grads = torch.autograd.grad(out, [qv] + geo, t(g), allow_unused=True)
    assert grads[0] is not None and grads[0].abs().sum() > 0
    assert all(gr is None for gr in grads[1:])


def test_backward_wrappers_take_plain_autograd_on_the_cpu():
    """The K6/K7 entry points (``*_bwd``) on CPU tensors: autograd of the
    plain version, equal to the gradients of the forward wrapper."""
    from cvd_tpu_torch.ops import epi_flash, temporal_attn

    q, k, v, g, geom = _epi_inputs(seed=17)
    geom = tuple(t(x) for x in geom)
    route = t(np.array([2, 3, 0, 1], np.int32))
    xs = [t(a, True) for a in (q, k, v)]
    want = torch.autograd.grad(epi_flash.epi_flash_attention(*xs, *geom, heads=2,
                                                             kv_index=route), xs, t(g))
    got = epi_flash.epi_flash_attention_bwd(t(q), t(k), t(v), geom, route, 2, None, None, t(g))
    for gi, wi in zip(got, want):
        torch.testing.assert_close(gi, wi)
    rng = np.random.default_rng(18)
    a = [t(rng.standard_normal((2, 8, 4, 32)).astype(np.float32), True) for _ in range(4)]
    want = torch.autograd.grad(temporal_attn.temporal_flash_attention(*a[:3], None, 4),
                               a[:3], a[3].detach())
    got = temporal_attn.temporal_flash_attention_bwd(*(x.detach() for x in a[:3]), None, 4,
                                                     a[3].detach())
    for gi, wi in zip(got, want):
        torch.testing.assert_close(gi, wi)
    assert epi_flash.epi_flash_attention_bwd.launches == 0

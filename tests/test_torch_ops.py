"""The port's ops (their plain PyTorch versions, which CPU tensors take)
against the JAX entry points of the Pallas kernels they stand beside.

The JAX side runs as its own tests run it on the CPU: the attention kernels
in Pallas interpret mode, group_norm / layer_norm_matmul with
``force_kernel=True``. The hand-written CUDA/Triton kernels themselves run
only on the card; ``chip_smoke.py`` holds them against these plain versions
there. Tolerance: f32 atol = rtol = 1e-5 (summation order only); 1e-4
where a 64- or 128-deep matmul sums in another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def _epi_inputs(feat, heads, dim, seed):
    from cvd_tpu.geometry.epipolar_mask import epipolar_lines, lines_and_band, pixel_grid_coords

    rng = np.random.default_rng(seed)
    B, N, C = 4, feat * feat, heads * dim
    q, k, v = (rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(3))
    F_mats = (rng.standard_normal((B, 3, 3)) * 1e-3).astype(np.float32)
    coords = pixel_grid_coords(feat, 256)
    lines, band, alpha = lines_and_band(epipolar_lines(jnp.asarray(F_mats), coords), feat, 256)
    coords_xy = np.asarray(coords[:, :2].T)
    return q, k, v, np.asarray(lines), coords_xy, np.asarray(band), np.asarray(alpha)


@pytest.mark.parametrize("feat", [16, 32])
@pytest.mark.parametrize("routed", [False, True])
def test_epi_flash_attention_plain_matches_jax(feat, routed):
    """K1: epipolar bias evaluated per (q, k), kv routed to the partner row."""
    from cvd_tpu.ops.epi_flash import epi_flash_attention as jax_epi
    from cvd_tpu_torch.ops.epi_flash import epi_flash_attention

    q, k, v, lines, coords, band, alpha = _epi_inputs(feat, 2, 8, seed=feat)
    route = np.array([2, 3, 0, 1], np.int32) if routed else None
    want = jax_epi(*(jnp.asarray(a) for a in (q, k, v, lines, coords, band, alpha)),
                   heads=2, kv_index=None if route is None else jnp.asarray(route))
    got = epi_flash_attention(t(q), t(k), t(v), t(lines), t(coords), t(band), t(alpha),
                              heads=2, kv_index=None if route is None else t(route))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_plain_matches_jax():
    """K2: the bias-free variant."""
    from cvd_tpu.ops.epi_flash import flash_attention as jax_flash
    from cvd_tpu_torch.ops.epi_flash import flash_attention

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 256, 16)).astype(np.float32) for _ in range(3))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=2)
    got = flash_attention(t(q), t(k), t(v), heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask_kind", ["", "causal"])
def test_temporal_attention_plain_matches_jax(mask_kind):
    """K3: per-pixel attention over frames, with and without a causal mask."""
    from cvd_tpu.models.motion import causal_temporal_mask as jax_mask
    from cvd_tpu.ops.temporal_attn import temporal_flash_attention as jax_temporal
    from cvd_tpu_torch.models.motion import causal_temporal_mask
    from cvd_tpu_torch.ops.temporal_attn import temporal_flash_attention

    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 16, 8, 32)).astype(np.float32) for _ in range(3))
    jmask = jax_mask(mask_kind, 8) if mask_kind else None
    pmask = causal_temporal_mask(mask_kind, 8) if mask_kind else None
    if mask_kind:
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    want = jax_temporal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, heads=4)
    got = temporal_flash_attention(t(q), t(k), t(v), pmask, heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _temporal_case(case, seed):
    """Seeded q [2, 16, F, 32], k, v [2, 16, G, 32] (4 heads) and a mask, as
    numpy, off the kernel's 16-frame tile: (q, k, v, mask or None, split)."""
    from cvd_tpu.models.motion import causal_temporal_mask as jax_mask

    rng = np.random.default_rng(seed)
    Fr, G = {"F12": (12, 12), "F16 G24": (16, 24)}.get(case, (16, 16))
    if case == "split views":  # q, k, v as the motion module gets them: one fused projection
        qkv = rng.standard_normal((2, 16, Fr, 96)).astype(np.float32)
        return qkv[..., :32], qkv[..., 32:64], qkv[..., 64:], None, qkv
    q = rng.standard_normal((2, 16, Fr, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, G, 32)).astype(np.float32) for _ in range(2))
    mask = {"F16 G24": rng.standard_normal((Fr, G)).astype(np.float32),
            "0 mask": np.asarray(jax_mask("0", Fr))}.get(case)
    return q, k, v, mask, None


TEMPORAL_CASES = ["F12", "F16 G24", "0 mask", "split views"]


@pytest.mark.parametrize("case", TEMPORAL_CASES)
def test_temporal_attention_plain_matches_jax_off_the_tile(case):
    """K3 away from 16 x 16 frames and contiguous inputs: 12 frames, 24 key
    frames under an arbitrary mask, the one-key "0" mask, and q/k/v as
    ``split`` views of one fused tensor; 1e-4 x max |ref|."""
    from cvd_tpu.ops.temporal_attn import temporal_flash_attention as jax_temporal
    from cvd_tpu_torch.models.motion import causal_temporal_mask
    from cvd_tpu_torch.ops.temporal_attn import temporal_flash_attention

    q, k, v, mask, fused = _temporal_case(case, seed=40)
    want = np.asarray(jax_temporal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   None if mask is None else jnp.asarray(mask), heads=4))
    if fused is not None:
        xs = t(fused).split(32, -1)
        assert not xs[1].is_contiguous()
    else:
        xs = (t(q), t(k), t(v))
    pmask = causal_temporal_mask("0", 16) if case == "0 mask" else (
        None if mask is None else t(mask))
    got = temporal_flash_attention(*xs, pmask, heads=4)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    if case == "0 mask":  # one allowed key: every frame's output is v's frame 0
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(v[:, :, :1], v.shape), atol=1e-6)


def _temporal_main_path_shapes():
    """(frames, head_dim, dtype, kernel) of every temporal attention the port
    reaches on a card: the SD1.5 UNet and its pose encoder in bf16 (sampling,
    training) and the smoke widths in f32 (the card-vs-CPU checks; their pose
    encoder keeps 8 heads) and bf16."""
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.pose_encoder import CameraPoseEncoder
    from cvd_tpu_torch.models.unet import UNetConfig

    rows = set()
    for cfg, dtypes in ((UNetConfig(), ("bfloat16",)), (SMOKE_UNET, ("float32", "bfloat16"))):
        pose = CameraPoseEncoder(channels=cfg.block_out_channels)
        pose_heads = pose.encoder_down_attention_blocks[0][0].attention_blocks[0].heads
        for ch in cfg.block_out_channels:
            for dt in dtypes:
                rows.add((16, ch // cfg.attention_heads, dt))
                if dt == "float32":
                    rows.add((2, ch // pose_heads, dt))
    return sorted(rows)


@pytest.mark.parametrize("frames,D,dtype", _temporal_main_path_shapes())
def test_temporal_kernel_route_on_the_main_paths(frames, D, dtype):
    """bf16 at every head_dim of the UNet, the pose encoder and the smoke
    widths takes the tensor-core kernels; f32 keeps the f32-product ones."""
    from cvd_tpu_torch.ops.temporal_attn import MMA_HEAD_DIMS, kernel_route

    assert D in (4, 8, 16, 40, 80, 160)
    assert kernel_route(frames, frames, D, dtype) == ("mma" if dtype == "bfloat16" else "fma")
    if dtype == "bfloat16":
        assert D in MMA_HEAD_DIMS


@pytest.mark.parametrize("F,G,D,dtype,want", [
    (12, 12, 40, "bfloat16", "mma"), (1, 1, 8, "bfloat16", "mma"), (16, 9, 160, "bfloat16", "mma"),
    (7, 16, 32, "bfloat16", "mma"), (16, 16, 64, "bfloat16", "mma"), (16, 16, 128, "bfloat16", "mma"),
    (16, 24, 40, "bfloat16", "fma"), (24, 24, 40, "bfloat16", "fma"), (17, 16, 40, "bfloat16", "fma"),
    (16, 17, 40, "bfloat16", "fma"), (32, 32, 80, "bfloat16", "fma"),
    (16, 16, 24, "bfloat16", "fma"), (16, 16, 48, "bfloat16", "fma"), (16, 16, 72, "bfloat16", "fma"),
    (16, 16, 96, "bfloat16", "fma"), (16, 16, 168, "bfloat16", "fma"),
    (16, 16, 40, "float32", "fma"), (12, 12, 4, "float32", "fma"), (32, 32, 160, "float32", "fma"),
])
def test_temporal_kernel_route_at_the_edges(F, G, D, dtype, want):
    """The one rule: bf16 with F, G <= 16 and a head_dim of MMA_HEAD_DIMS
    takes the tensor-core kernels, all else the wrapper accepts the kept ones."""
    from cvd_tpu_torch.ops.temporal_attn import kernel_route

    assert kernel_route(F, G, D, dtype) == want


@pytest.mark.parametrize("F,G,D,dtype,error", [
    (33, 16, 40, "bfloat16", ValueError), (16, 33, 40, "float32", ValueError),
    (0, 16, 40, "bfloat16", ValueError), (16, 16, 4, "bfloat16", ValueError),
    (16, 16, 36, "bfloat16", ValueError), (16, 16, 6, "float32", ValueError),
    (16, 16, 0, "float32", ValueError), (16, 16, 40, "float16", TypeError),
    (16, 16, 40, "float64", TypeError),
])
def test_temporal_kernel_route_raises(F, G, D, dtype, error):
    from cvd_tpu_torch.ops.temporal_attn import kernel_route

    with pytest.raises(error):
        kernel_route(F, G, D, dtype)


@pytest.mark.parametrize("heads,D,want", [
    (8, 40, 8), (8, 80, 4), (8, 160, 2), (4, 8, 4), (4, 16, 4), (8, 8, 8), (8, 128, 2),
    (16, 8, 8), (6, 40, 6), (1, 160, 1), (3, 160, 1), (5, 64, 5),
])
def test_temporal_head_group(heads, D, want):
    """Heads a block takes: a divisor of heads, at most 8 warps, at most 640
    bytes of a row (res 32, 16 and 8 of SD1.5: 8, 4 and 2)."""
    from cvd_tpu_torch.ops.temporal_attn import head_group

    got = head_group(heads, D)
    assert got == want and heads % got == 0 and got <= 8
    assert got == 1 or got * D * 2 <= 640


def test_temporal_route_constants_match_the_cuda_header():
    """``kernel_route`` and ``head_group`` promise the tensor-core kernels only
    what ``csrc/temporal_mma.cuh`` instantiates and checks: its head_dim
    dispatch, its 16-row tile and its 8 warps a block."""
    import re
    from pathlib import Path

    from cvd_tpu_torch.ops import _build, temporal_attn

    header = Path(_build.CSRC / "temporal_mma.cuh").read_text()
    dims = tuple(int(d) for d in re.findall(r"case (\d+): return fn\(", header))
    assert dims == temporal_attn.MMA_HEAD_DIMS
    assert all(f"integral_constant<int, {d // 8}>" in header for d in dims)
    assert f"constexpr int ROWS = {temporal_attn.MMA_MAX_FRAMES};" in header
    assert f"constexpr int MAX_WARPS = {temporal_attn._MMA_MAX_WARPS};" in header


def test_temporal_prepare_keeps_split_views_and_refuses_early():
    """``_prepare``: the split views of a fused bf16 projection go to the
    kernel uncopied (same storage, frame stride 3C); what no kernel takes
    raises before any build."""
    from cvd_tpu_torch.ops import temporal_attn

    fused = torch.zeros(2, 8, 16, 3 * 320, dtype=torch.bfloat16)
    q, k, v = fused.split(320, -1)
    mask = torch.zeros(16, 16)
    pq, pk, pv, pm = temporal_attn._prepare(q, k, v, mask, 8)
    for got, view in ((pq, q), (pk, k), (pv, v)):
        assert got.data_ptr() == view.data_ptr() and got.stride() == view.stride()
        assert got.stride(2) == 960
    assert pm.dtype == torch.float32 and pm.shape == (16, 16)
    with pytest.raises(ValueError):
        temporal_attn._prepare(q, k, v, torch.zeros(16, 8), 8)
    wide = torch.zeros(2, 8, 33, 320, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        temporal_attn._prepare(wide, wide, wide, None, 8)
    with pytest.raises(ValueError):  # head_dim 4 in bf16 is 8 bytes
        temporal_attn._prepare(q[..., :32], k[..., :32], v[..., :32], None, 8)
    with pytest.raises(TypeError):
        temporal_attn._prepare(q.half(), k.half(), v.half(), None, 8)
    assert temporal_attn.temporal_flash_attention.launches == 0


@pytest.mark.parametrize("arithmetic", ["bfloat16", "float32"])
def test_temporal_forward_bound_at_the_timed_shape(arithmetic):
    """K3 at B4 N1024 F16 C320 in bf16: 168 MB, 0.050 ms by bytes whichever
    unit does the products; a mask adds its F x F floats."""
    from cvd_tpu_torch.ops import work

    flops, moved = work.temporal_fwd(4, 1024, 16, 320, 2)
    assert moved == 4 * 4 * 1024 * 16 * 320 * 2
    bound, by = work.bound_ms(flops, moved, arithmetic)
    assert by == "bytes" and bound == pytest.approx(0.0501, rel=5e-3)
    assert work.temporal_fwd(4, 1024, 16, 320, 2, has_mask=True) == (flops, moved + 16 * 16 * 4)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_plain_matches_jax(act):
    """K4: GroupNorm with f32 stats, with and without the fused SiLU."""
    from cvd_tpu.ops.norms import group_norm as jax_gn
    from cvd_tpu_torch.ops.norms import group_norm

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 8, 8, 64)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jax_gn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 32, eps=1e-6, act=act,
                  force_kernel=True)
    got = group_norm(t(x), t(g), t(b), 32, eps=1e-6, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_proj", [1, 3])
def test_layer_norm_matmul_plain_matches_jax(n_proj):
    """K5: LayerNorm folded into 1 or 3 projections."""
    from cvd_tpu.ops.ln_matmul import layer_norm_matmul as jax_lnmm
    from cvd_tpu_torch.ops.ln_matmul import layer_norm_matmul

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    ws = [(rng.standard_normal((128, 128)) * 0.1).astype(np.float32) for _ in range(n_proj)]
    bs = [None] * n_proj
    if n_proj == 1:
        bs = [rng.standard_normal(128).astype(np.float32)]
    want = jax_lnmm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                    [jnp.asarray(w) for w in ws],
                    [None if c is None else jnp.asarray(c) for c in bs], force_kernel=True)
    got = layer_norm_matmul(t(x), t(g), t(b), [t(w.T.copy()) for w in ws],
                            [None if c is None else t(c) for c in bs])
    assert len(got) == n_proj
    for gi, wi in zip(got, want):
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-4, atol=1e-4)


def test_fold_weights_matches_layer_norm_then_matmul():
    """The gamma/beta folding the CUDA route feeds kernel K5
    (ln_matmul.py:183-195): x_hat @ W'^T + b' == LN(x) @ W^T + b."""
    from cvd_tpu_torch.ops.ln_matmul import _reference, fold_weights

    rng = np.random.default_rng(7)
    x = t(rng.standard_normal((32, 64)).astype(np.float32))
    g, b = (t(rng.standard_normal(64).astype(np.float32)) for _ in range(2))
    ws = [t(rng.standard_normal((n, 64)).astype(np.float32)) for n in (64, 96)]
    bs = [None, t(rng.standard_normal(96).astype(np.float32))]
    w_f, b_f = fold_weights(g, b, ws, bs, torch.float32)
    x_hat = torch.nn.functional.layer_norm(x, (64,), eps=1e-5)
    got = x_hat @ w_f.T + b_f
    np.testing.assert_allclose(got.numpy(), _reference(x, g, b, ws, bs, 1e-5).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_attention_with_bias_matches_jax():
    from cvd_tpu.ops.attention import attention_with_bias as jax_attn
    from cvd_tpu_torch.ops.attention import attention_with_bias

    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 4, 16, 8)).astype(np.float32) for _ in range(3))
    bias = -np.abs(rng.standard_normal((2, 16, 16))).astype(np.float32)
    want = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    got = attention_with_bias(t(q), t(k), t(v), t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain path."""

    @property
    def device(self):
        return torch.device("xpu")


def test_ops_raise_on_a_device_without_a_kernel():
    """A wrapper runs its plain version only for tensors on
    ``ops.PLAIN_DEVICES`` (the CPU, and ``meta`` for counting); on any other
    device but CUDA it raises."""
    from cvd_tpu_torch.ops.norms import group_norm

    x = torch.Tensor._make_subclass(_Elsewhere, torch.zeros(2, 4, 32))
    assert x.device.type == "xpu"
    with pytest.raises(ValueError, match="no kernel for xpu"):
        group_norm(x, torch.ones(32), torch.zeros(32), 8)


def _fold_inputs(seed=8, n_proj=3, c=64):
    rng = np.random.default_rng(seed)
    g, b = (t(rng.standard_normal(c).astype(np.float32)) for _ in range(2))
    ws = [t((rng.standard_normal((n, c)) * 0.1).astype(np.float32)) for n in (64, 96, 32)[:n_proj]]
    bs = [None] * n_proj if n_proj > 1 else [t(rng.standard_normal(64).astype(np.float32))]
    return g, b, ws, bs


def test_fold_cache_returns_the_same_objects_until_a_source_is_written():
    """The fold that feeds K5 is cached per layer: the same (W', b') objects
    on a second call, new ones after an in-place write to any source (what
    an optimizer step or load_state_dict does), equal to a fresh fold."""
    from cvd_tpu_torch.ops.ln_matmul import fold_weights, folded

    g, b, ws, bs = _fold_inputs()
    first = folded(g, b, ws, bs, torch.float32)
    again = folded(g, b, ws, bs, torch.float32)
    assert again[0] is first[0] and again[1] is first[1]
    ws[1].add_(0.5)   # an in-place update bumps the tensor's _version
    after = folded(g, b, ws, bs, torch.float32)
    assert after[0] is not first[0]
    fresh = fold_weights(g, b, ws, bs, torch.float32)
    torch.testing.assert_close(after[0], fresh[0], rtol=0, atol=0)
    torch.testing.assert_close(after[1], fresh[1], rtol=0, atol=0)
    assert not torch.equal(after[0], first[0])
    assert folded(g, b, ws, bs, torch.float32)[0] is after[0]


@pytest.mark.parametrize("which", ["gamma", "beta", "bias", "optimizer"])
def test_fold_cache_sees_every_source(which):
    from cvd_tpu_torch.ops.ln_matmul import folded

    g, b, ws, bs = _fold_inputs(n_proj=1)
    w = torch.nn.Parameter(ws[0])
    first = folded(g, b, [w], bs, torch.float32)
    if which == "gamma":
        g.mul_(2.0)
    elif which == "beta":
        b.add_(1.0)
    elif which == "bias":
        bs[0].sub_(1.0)
    else:  # AdamW writes the master weight in place
        opt = torch.optim.AdamW([w], lr=1e-2)
        w.grad = torch.ones_like(w)
        opt.step()
    after = folded(g, b, [w], bs, torch.float32)
    assert after[0] is not first[0]
    changed = after[1] if which in ("beta", "bias") else after[0]
    before = first[1] if which in ("beta", "bias") else first[0]
    assert not torch.equal(changed, before)


def test_fold_cache_keys_on_dtype_and_on_the_tensor_not_its_id():
    """A cast copy of a weight (what ``.to(dtype)`` hands over) is another
    tensor: it never takes a stale entry, and its entry goes with it."""
    from cvd_tpu_torch.ops import ln_matmul

    g, b, ws, bs = _fold_inputs()
    f32 = ln_matmul.folded(g, b, ws, bs, torch.float32)
    bf16 = ln_matmul.folded(g, b, ws, bs, torch.bfloat16)
    assert bf16[0].dtype == torch.bfloat16 and f32[0].dtype == torch.float32
    assert ln_matmul.folded(g, b, ws, bs, torch.float32)[0] is f32[0]
    n = len(ln_matmul._FOLDS)
    for scale in (1.0, 2.0):
        cast = [(w * scale).to(torch.float64).to(torch.float32) for w in ws]
        got = ln_matmul.folded(g, b, cast, bs, torch.float32)
        want = ln_matmul.fold_weights(g, b, cast, bs, torch.float32)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        del cast, got
    assert len(ln_matmul._FOLDS) <= n + 1   # the temporaries' entries were dropped


@pytest.mark.parametrize("n_proj", [1, 3])
def test_folded_product_matches_jax_layer_norm_matmul(n_proj):
    """What K5 computes on the card, in plain f32 on the CPU: standardize,
    multiply the cached folded weight, add the folded bias; against the JAX
    layer_norm_matmul (Pallas, interpret mode) at 1e-4 x max|ref|."""
    from cvd_tpu.ops.ln_matmul import layer_norm_matmul as jax_lnmm
    from cvd_tpu_torch.ops.ln_matmul import folded

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    ws = [(rng.standard_normal((128, 128)) * 0.1).astype(np.float32) for _ in range(n_proj)]
    bs = [None] * n_proj if n_proj > 1 else [rng.standard_normal(128).astype(np.float32)]
    want = np.concatenate([np.asarray(o) for o in jax_lnmm(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), [jnp.asarray(w) for w in ws],
        [None if c is None else jnp.asarray(c) for c in bs], force_kernel=True)], -1)
    tw = [t(w.T.copy()) for w in ws]
    tb = [None if c is None else t(c) for c in bs]
    tg, tbeta = t(g), t(b)
    for _ in range(2):   # the second pass takes the cached fold
        w_f, b_f = folded(tg, tbeta, tw, tb, torch.float32)
        x_hat = torch.nn.functional.layer_norm(t(x), (128,), eps=1e-5)
        got = (x_hat @ w_f.T + b_f).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("T", [1024, 4096, 16384])
@pytest.mark.parametrize("C,K,want", [(320, 960, "panel"), (320, 2560, "panel"),
                                      (640, 1920, "wide"), (640, 5120, "wide"),
                                      (1280, 3840, "wide"), (1280, 10240, "wide"),
                                      (1280, 1288, "wide")])
def test_ln_matmul_kernel_route_on_the_main_paths(T, C, K, want):
    """bf16: the token panel up to C 320, the streamed 128-token tiles above;
    f32 keeps its own pair of kernels at every width."""
    from cvd_tpu_torch.ops.ln_matmul import kernel_route

    assert kernel_route(T, C, K, "bfloat16") == want
    assert kernel_route(T, C, K, "float32") == "f32"


@pytest.mark.parametrize("T,C,K,dtype,want", [
    (64, 1280, 3840, "bfloat16", "wide"), (4104, 1280, 3840, "bfloat16", "wide"),
    (1, 328, 8, "bfloat16", "wide"), (1000, 704, 1288, "bfloat16", "wide"),
    (65536, 640, 1920, "bfloat16", "wide"), (777, 64, 256, "bfloat16", "panel"),
    (512, 32, 96, "bfloat16", "panel"), (0, 320, 960, "bfloat16", "panel"),
    (16, 2048, 100, "float32", "f32"), (16, 4, 3, "float32", "f32"),
])
def test_ln_matmul_kernel_route_at_the_edges(T, C, K, dtype, want):
    from cvd_tpu_torch.ops.ln_matmul import kernel_route

    assert kernel_route(T, C, K, dtype) == want


@pytest.mark.parametrize("T,C,K,dtype,error", [
    (1024, 1344, 3840, "bfloat16", ValueError), (1024, 1288, 3840, "bfloat16", ValueError),
    (1024, 1280, 3844, "bfloat16", ValueError), (1024, 320, 962, "bfloat16", ValueError),
    (1024, 1284, 3840, "bfloat16", ValueError), (1024, 322, 960, "float32", ValueError),
    (1024, 1280, 3840, "float16", TypeError), (1024, 1280, 3840, "float64", TypeError),
])
def test_ln_matmul_kernel_route_raises_where_the_wrapper_raises(T, C, K, dtype, error):
    """What no kernel takes: kernel_route and the launch refuse it alike,
    before anything is built."""
    from cvd_tpu_torch.ops import ln_matmul

    with pytest.raises(error):
        ln_matmul.kernel_route(T, C, K, dtype)
    dt = getattr(torch, dtype)
    with pytest.raises(error):
        ln_matmul._launch(torch.zeros(T, C, dtype=dt), torch.zeros(K, C, dtype=dt),
                          torch.zeros(K), 1e-5)


def test_ln_matmul_route_constants_match_the_cuda_dispatch():
    """kernel_route promises each route what ``ln_matmul_fwd``'s dispatch
    gives it: the panel kernel up to 5 atoms of 64 channels (C 320), the wide
    kernel up to 20 (C 1280)."""
    import re
    from pathlib import Path

    from cvd_tpu_torch.ops import _build, ln_matmul

    src = Path(_build.CSRC / "ln_matmul_fwd.cu").read_text()
    dispatch = src[src.index('extern "C" int ln_matmul_fwd('):]
    found = re.findall(r"if \(CB <= (\d+)\)\n    return static_cast<int>\(launch_(bf16<128, 128>|wide)\(",
                       dispatch)
    assert [(int(cb), kind) for cb, kind in found] == [
        (ln_matmul._PANEL_MAX_C // 64, "bf16<128, 128>"), (ln_matmul._MAX_C_BF16 // 64, "wide")]


def test_layer_norm_matmul_counts_launches_by_route(monkeypatch):
    """``layer_norm_matmul.routes`` counts each kernel launch under the route
    the dispatch takes for its shape and type, beside ``launches``; the CPU's
    plain path counts nothing. (The kernel itself is stood in for: a tensor
    that says it is on the card, and a ``_fused`` that returns zeros.)"""
    from cvd_tpu_torch.ops import ln_matmul

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def fused(x, gamma, beta, weights, biases, eps):
        return torch.zeros(*x.shape[:-1], sum(w.shape[0] for w in weights), dtype=x.dtype)

    fn = ln_matmul.layer_norm_matmul
    monkeypatch.setattr(ln_matmul, "_fused", fused)
    monkeypatch.setattr(fn, "routes", {"panel": 0, "wide": 0, "f32": 0})
    monkeypatch.setattr(fn, "launches", 0)
    calls = [((4, 1024, 320), (320, 320, 320), torch.bfloat16),
             ((4, 256, 1280), (10240,), torch.bfloat16),
             ((4, 16, 1280), (1280, 1280, 1280), torch.bfloat16),
             ((4, 16, 1280), (1280,), torch.float32),
             ((2, 64, 320), (2560,), torch.bfloat16)]
    with torch.no_grad():
        for shape, Ks, dtype in calls:
            C = shape[-1]
            x = torch.zeros(shape, dtype=dtype).as_subclass(OnCard)
            out = fn(x, torch.ones(C), torch.zeros(C), [torch.zeros(K, C) for K in Ks],
                     [None] * len(Ks))
            assert [o.shape[-1] for o in out] == list(Ks)
        fn(torch.zeros(2, 8, 1280), torch.ones(1280), torch.zeros(1280),
           [torch.zeros(16, 1280)], [None])   # the CPU: plain, not counted
    assert fn.launches == len(calls)
    assert fn.routes == {"panel": 2, "wide": 2, "f32": 1}


def test_graph_bookkeeping_carries_k5_routes(monkeypatch):
    """A CUDA graph's replay adds the launches its capture counted, K5's by
    route beside its total (``utils/graphs``), so that ``routes`` sums to
    ``launches`` on a captured path too."""
    from cvd_tpu_torch.ops import ln_matmul
    from cvd_tpu_torch.utils import graphs

    fn = ln_matmul.layer_norm_matmul
    monkeypatch.setattr(fn, "routes", {"panel": 1, "wide": 2, "f32": 0})
    monkeypatch.setattr(fn, "launches", 3)
    counts = graphs.launch_counts()
    assert counts["layer_norm_matmul"] == 3 and counts["layer_norm_matmul/wide"] == 2
    into = {n: 0 for n in counts}
    graphs.add_launches({"layer_norm_matmul": 2, "layer_norm_matmul/wide": 2}, into)
    assert fn.launches == 5 and fn.routes == {"panel": 1, "wide": 4, "f32": 0}
    assert into["layer_norm_matmul"] == 2 and into["layer_norm_matmul/wide"] == 2


# every GroupNorm input of the SD1.5 UNet at 256 px (64 frame rows): (S, C) of
# the down path, the mid block and the up path's concatenations
UNET_GN_SHAPES = [(1024, 320), (1024, 640), (1024, 960), (256, 320), (256, 640), (256, 960),
                  (256, 1280), (256, 1920), (64, 640), (64, 1280), (64, 1920), (64, 2560),
                  (16, 1280), (16, 2560)]


@pytest.mark.parametrize("S, C", UNET_GN_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_group_norm_plan_takes_one_pass_for_every_unet_slab(S, C, itemsize):
    """K4's path function on an H100 (132 SMs): one launch, the padded slab
    within the block limit, the bundle a divisor of the groups, a program for
    every SM, and a pixel's piece at least 64 bytes unless a wider bundle
    would no longer fit."""
    from cvd_tpu_torch.ops.norms import ONE_PASS_MAX_BLOCK, _next_pow2, plan

    R, G = 64, 32
    p = plan(R, S, C, G, itemsize, 132)
    cg = C // G
    assert p.one_pass and G % p.bundle == 0
    assert p.block_s >= S and p.block_c >= p.bundle * cg
    assert p.block_s * p.block_c <= ONE_PASS_MAX_BLOCK
    assert R * G // p.bundle >= 132
    assert 1 <= p.num_warps <= 16 and p.num_warps & (p.num_warps - 1) == 0
    wider_fits = p.block_s * _next_pow2(2 * p.bundle * cg) <= ONE_PASS_MAX_BLOCK
    assert p.bundle * cg * itemsize >= 64 or not wider_fits


@pytest.mark.parametrize("R, S, C, block_s, nsplit, s_per_split, apply_block_s", [
    (32, 65536, 128, 1024, 1, 65536, 64), (8, 65536, 128, 1024, 4, 16384, 64),
    (32, 16384, 256, 512, 1, 16384, 32), (32, 4096, 512, 256, 1, 4096, 16),
    (1, 262144, 128, 1024, 32, 8192, 64)])
def test_group_norm_plan_splits_the_vae_rows_as_before(R, S, C, block_s, nsplit, s_per_split,
                                                       apply_block_s):
    """Rows no block can hold keep the three-launch path with the split it had
    before there was a one-pass path, written out for 132 SMs: [block_s, C/G]
    tiles of 4096 elements, about 8 programs an SM."""
    from cvd_tpu_torch.ops.norms import plan

    p = plan(R, S, C, 32, 2, 132)
    assert not p.one_pass
    assert (p.block_s, p.block_c) == (block_s, C // 32)
    assert (p.nsplit, p.s_per_split) == (nsplit, s_per_split)
    assert (p.apply_block_s, p.apply_block_c) == (apply_block_s, C)


def test_group_norm_plan_keeps_a_program_for_every_sm():
    """Few rows: the bundle stops growing when the grid would fall under the
    SM count, whatever the piece size."""
    from cvd_tpu_torch.ops.norms import plan

    assert plan(64, 1024, 320, 32, 2, 132).bundle == 2
    assert plan(4, 1024, 320, 32, 2, 132).bundle == 1
    assert plan(64, 1024, 320, 32, 2, 2048).bundle == 1


@pytest.mark.parametrize("cg, S", [(10, 200), (30, 72)])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax_off_powers_of_two(cg, S, act):
    """C/G = 10 and 30 (C 320 and 960) with a pixel count that is no power of
    two: the plain version vs the JAX group_norm through its kernel."""
    from cvd_tpu.ops.norms import group_norm as jax_gn
    from cvd_tpu_torch.ops.norms import group_norm

    rng = np.random.default_rng(21)
    C = 32 * cg
    x = (rng.standard_normal((3, S, C)) * 2 + 3).astype(np.float32)
    gam, bet = (rng.standard_normal(C).astype(np.float32) for _ in range(2))
    want = jax_gn(jnp.asarray(x), jnp.asarray(gam), jnp.asarray(bet), 32, eps=1e-6, act=act,
                  force_kernel=True)
    got = group_norm(t(x), t(gam), t(bet), 32, eps=1e-6, act=act)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())

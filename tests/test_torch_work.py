"""``cvd_tpu_torch.ops.work``: the flops, bytes and roofline bound of each
kernel at the shapes ``chip_smoke.py`` times (bf16, H100 SXM peaks: 989
TFLOP/s, 67 TFLOP/s f32, 3.35 TB/s), and their scaling with the shapes."""
import pytest

from cvd_tpu_torch.ops import work

BF16 = 2

# (kernel, work function, args, kwargs, arithmetic type, GFLOP, MB, bound ms, bound by)
TABLE = [
    ("K1", work.attention_fwd, (64, 8, 1024, 1024, 40, BF16), dict(has_bias=True, routed=True),
     "bfloat16", 85.90, 170.7, 0.0869, "operations"),
    ("K2", work.attention_fwd, (64, 8, 1024, 1024, 40, BF16), {},
     "bfloat16", 85.90, 169.9, 0.0869, "operations"),
    ("K3", work.temporal_fwd, (4, 1024, 16, 320, BF16), {},
     "bfloat16", 1.342, 167.8, 0.0501, "bytes"),
    ("K4 UNet", work.group_norm, (64, 1024, 320, BF16), {},
     "float32", 0.2726, 83.89, 0.0250, "bytes"),
    ("K4 VAE", work.group_norm, (32, 65536, 128, BF16), {},
     "float32", 3.490, 1073.7, 0.3205, "bytes"),
    ("K5", work.ln_matmul, (65536, 320, 2560, BF16), {},
     "bfloat16", 107.4, 379.1, 0.1132, "bytes"),
    ("K6", work.attention_bwd, (32, 8, 1024, 1024, 40, BF16), dict(has_bias=True, routed=True),
     "bfloat16", 107.4, 169.2, 0.1086, "operations"),
    ("K6 no bias", work.attention_bwd, (32, 8, 1024, 1024, 40, BF16), {},
     "bfloat16", 107.4, 168.8, 0.1086, "operations"),
    ("K7", work.temporal_bwd, (2, 1024, 16, 320, BF16), {},
     "bfloat16", 1.678, 146.8, 0.0438, "bytes"),
]


@pytest.mark.parametrize("name,fn,args,kwargs,dtype,gflop,mb,ms,by", TABLE,
                         ids=[row[0] for row in TABLE])
def test_work_and_bound_at_the_timed_shapes(name, fn, args, kwargs, dtype, gflop, mb, ms, by):
    flops, moved = fn(*args, **kwargs)
    assert flops / 1e9 == pytest.approx(gflop, rel=2e-3)
    assert moved / 1e6 == pytest.approx(mb, rel=2e-3)
    bound, bound_by = work.bound_ms(flops, moved, dtype)
    assert bound == pytest.approx(ms, rel=5e-3)
    assert bound_by == by


def test_k5_bounds_meet():
    """K5 is bound by memory, with the tensor-core bound 4% below it."""
    flops, moved = work.ln_matmul(65536, 320, 2560, BF16)
    assert flops == 2 * 65536 * 320 * 2560
    assert moved == (65536 * 320 + 2560 * 320 + 65536 * 2560) * 2 + 2560 * 4
    assert flops / 989e12 * 1e3 == pytest.approx(0.1086, rel=2e-3)
    assert work.bound_ms(flops, moved, "bfloat16") == (moved / 3.35e12 * 1e3, "bytes")


@pytest.mark.parametrize("fn,args,axis,power", [
    (work.attention_fwd, (2, 8, 256, 256, 40, BF16), 2, 1),   # Lq: products linear in Lq
    (work.attention_fwd, (2, 8, 256, 256, 40, BF16), 0, 1),   # batch rows
    (work.attention_bwd, (2, 8, 256, 256, 40, BF16), 3, 1),   # Lk
    (work.temporal_fwd, (2, 64, 16, 320, BF16), 2, 2),        # frames: F^2 logits
    (work.temporal_bwd, (2, 64, 16, 320, BF16), 1, 1),        # pixels
    (work.ln_matmul, (1024, 320, 960, BF16), 2, 1),           # outputs
    (work.group_norm, (4, 256, 320, BF16), 1, 1),             # positions
])
def test_flops_scale_as_the_formulas_say(fn, args, axis, power):
    doubled = list(args)
    doubled[axis] *= 2
    assert fn(*doubled)[0] == fn(*args)[0] * 2 ** power


def test_backward_is_five_products_of_the_forwards_two():
    args = (32, 8, 1024, 1024, 40, BF16)
    assert work.attention_bwd(*args)[0] * 2 == work.attention_fwd(*args)[0] * 5
    assert work.temporal_bwd(2, 1024, 16, 320, BF16)[0] * 2 == \
        work.temporal_fwd(2, 1024, 16, 320, BF16)[0] * 5


def test_bytes_follow_the_itemsize_and_the_geometry():
    f32 = work.attention_fwd(4, 8, 64, 64, 40, 4)[1]
    bf16 = work.attention_fwd(4, 8, 64, 64, 40, 2)[1]
    lse = 4 * 8 * 64 * 4
    assert f32 - lse == 2 * (bf16 - lse)
    plain = work.attention_fwd(4, 8, 64, 64, 40, 2)[1]
    biased = work.attention_fwd(4, 8, 64, 64, 40, 2, has_bias=True, routed=True)[1]
    assert biased - plain == (4 * 64 * 3 + 2 * 64 + 2 * 4 + 4) * 4


def test_bound_takes_the_larger_limit():
    assert work.bound_ms(989e12, 1.0, "bfloat16") == (1e3, "operations")
    assert work.bound_ms(1.0, 3.35e12, "bfloat16") == (1e3, "bytes")
    # the same operations outside the tensor cores are 989 / 67 times slower
    assert work.bound_ms(67e12, 1.0, "float32")[0] == pytest.approx(1e3)
    with pytest.raises(KeyError):
        work.bound_ms(1.0, 1.0, "int8")

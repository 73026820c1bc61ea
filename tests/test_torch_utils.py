"""The port's utilities against cvd_tpu's, on the CPU:

* ``utils.flops.unet_apply_flops(2, 2, 8)`` on ``meta`` against cvd_tpu's
  live count (XLA's cost analysis, ~30 s). The port counts products and
  convolutions at their nominal size; XLA counts a padded convolution's taps
  inside the input only and adds one per element of the elementwise ops.
  ``tests/torch_flop_accounting.py`` splits both counts: the products are
  equal to the unit, the port's convolutions under XLA's rule equal XLA's,
  and the rest is XLA's elementwise count. That is the tolerance: the
  counts must meet those identities exactly, and their totals differ by
  the padded taps less the elementwise count (+7.62% here).
* ``utils.profiling``: ``trace(None)``, ``trace(dir)`` on the CPU, and
  ``kernel_summary`` on a stub of ``key_averages()``.
* ``utils.visualize.visualize_correspondence`` bit-equal to cvd_tpu's, fed
  from the q / k maps of the tiny UNet's ``return_extras``.
* ``data.extract_frames`` on written mp4 clips: the pngs of both packages'
  ``extract_clip`` equal bit for bit, and the CLI's layout.
"""
import os
import random
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(2)


# ------------------------------------------------------------------- flops

def test_unet_flops_against_cvd_tpu_and_the_accounting():
    import jax

    from cvd_tpu.utils.flops import unet_apply_flops as jax_flops
    from torch_flop_accounting import jax_counts, port_counts

    from cvd_tpu_torch.utils.flops import unet_apply_flops, unet_flop_counts

    got = unet_apply_flops(2, 2, 8)
    assert got == 93_094_260_160
    jax.config.update("jax_platforms", "cpu")
    want = jax_flops(2, 2, 8)
    assert want == 86_506_749_952
    p, j = port_counts(2, 2, 8), jax_counts(2, 2, 8)
    assert p["total"] == got and j["total"] == want
    assert p["products"] == j["dots"]          # the same matrix products
    assert p["conv_inside"] == j["conv"]       # the same convolutions, counted XLA's way
    assert p["conv"] == p["conv_check"]
    assert got - (p["conv"] - p["conv_inside"]) + j["rest"] == want
    assert got / want - 1 == pytest.approx(0.0762, abs=5e-4)
    # per module: the UNet's blocks sum to the whole
    counts = unet_flop_counts(2, 2, 8)
    blocks = [m for m in counts if re.fullmatch(
        r"UNet3DConditionModel\.(conv_in|conv_out|time_embedding|mid_block|"
        r"(down|up)_blocks\.\d)", m)]
    assert len(blocks) == 12
    assert sum(sum(counts[m].values()) for m in blocks) == got == sum(counts["Global"].values())


def test_flops_cli_and_cache(tmp_path, capsys, monkeypatch):
    from cvd_tpu_torch.utils import flops

    flops.main(["--batch", "1", "--frames", "2", "--latent", "8", "--f32"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    n = __import__("json").loads(line)["flops"]
    assert n == flops.unet_apply_flops(1, 2, 8, bf16=False) > 0
    assert flops.cached_unet_flops(1, 2, 8, False, cache_dir=str(tmp_path)) == n
    monkeypatch.setattr(flops, "unet_apply_flops", lambda *a: pytest.fail("not cached"))
    assert flops.cached_unet_flops(1, 2, 8, False, cache_dir=str(tmp_path)) == n
    assert os.listdir(tmp_path) == ["flops_b1_f2_l8_0.json"]


def test_meta_tensors_take_the_plain_paths():
    from cvd_tpu_torch.ops import PLAIN_DEVICES
    from cvd_tpu_torch.ops.norms import group_norm

    assert PLAIN_DEVICES == ("cpu", "meta")
    x = torch.empty(2, 16, 8, device="meta")
    y = group_norm(x, torch.empty(8, device="meta"), torch.empty(8, device="meta"), 4)
    assert y.is_meta and y.shape == x.shape and group_norm.launches == 0


# --------------------------------------------------------------- profiling

def test_trace(tmp_path):
    from cvd_tpu_torch.utils.profiling import trace

    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(4) @ torch.ones(4)
    assert prof is not None and os.path.getsize(tmp_path / "t" / "trace.json") > 0


class _Avg:
    """A stand-in for one row of ``prof.key_averages()``."""

    def __init__(self, key, device, self_us, annotation=False, count=1):
        self.key, self.count = key, count
        self.device_type = f"DeviceType.{device}"
        self.self_device_time_total = self_us if device == "CUDA" else 0
        self.self_cpu_time_total = 0 if device == "CUDA" else self_us
        self.is_user_annotation = annotation


class _Averages(list):
    def table(self, sort_by, row_limit):
        return f"{len(self)} rows by {sort_by}"


def test_kernel_summary_counts_no_user_ranges():
    """Device time is kernels', copies' and memsets': the optimizer's range
    on the device's timeline (32 ms here, spanning the AdamW kernels) and a
    program span's range are not, so the idle share is that of the rest."""
    from cvd_tpu_torch.utils.profiling import kernel_summary

    class Prof:
        def key_averages(self):
            return _Averages([
                _Avg("ln_mm_kernel", "CUDA", 40_000, count=2),
                _Avg("Memcpy HtoD (Pageable -> Device)", "CUDA", 8_000),
                _Avg("Memset (Device)", "CUDA", 2_000),
                _Avg("Optimizer.step#AdamW.step", "CUDA", 32_000, annotation=True),
                _Avg("cvd/train.fill", "CUDA", 9_000, annotation=True),
                _Avg("aten::mm", "CPU", 5_000)])

    got = kernel_summary(Prof(), wall_s=0.1, steps=2, what="two steps",
                         families=("ln_mm",))
    assert got["device_ms"] == pytest.approx(25.0)       # (40 + 8 + 2) ms over 2 steps
    assert got["idle_share"] == pytest.approx(0.5)       # 50 of 100 ms
    assert not any("Optimizer" in line or "cvd/" in line for line in got["lines"])
    assert got["lines"][-1].endswith("every ln_mm*") and "20.00 ms" in got["lines"][-1]


# --------------------------------------------------------------- visualize

def test_visualize_correspondence_equals_cvd_tpus():
    from cvd_tpu.utils.visualize import visualize_correspondence as jax_vis
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.models.unet import UNet3DConditionModel
    from cvd_tpu_torch.pipelines.common import random_init_
    from cvd_tpu_torch.utils.visualize import visualize_correspondence

    Fr, S = 2, 8
    unet = random_init_(UNet3DConditionModel(SMOKE_UNET), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    lat = torch.from_numpy(rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 24)).astype(np.float32))
    F_mats = (rng.standard_normal((2 * Fr, 3, 3)) * 1e-3).astype(np.float32)
    cond = EpiConditioning(F_mats=torch.from_numpy(F_mats), video_length=Fr,
                           rand_slope_ff=False)
    with torch.no_grad():
        _, extras = unet(lat, 500, ctx, None, cond, return_extras=True)
    aux = {k: v.numpy() for k, v in extras["epi_qk"][-1].items()}
    assert aux["query"].shape == (2 * Fr, S * S, SMOKE_UNET.block_out_channels[0])
    videos = rng.random((2, Fr, 8 * S, 8 * S, 3)).astype(np.float32)
    for frame in (None, 0):
        got = visualize_correspondence(videos, aux, F_mats[:Fr] * 1e3, frame=frame,
                                       rng=random.Random(5))
        want = jax_vis(videos, aux, F_mats[:Fr] * 1e3, frame=frame, rng=random.Random(5))
        assert got.dtype == np.uint8 and got.shape == (8 * S, 16 * S, 3)
        assert np.array_equal(got, want)


# ----------------------------------------------------------- extract_frames

def test_extract_frames_from_written_mp4(tmp_path):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    from test_data import _smooth_frames, write_pose_file

    from cvd_tpu.data.extract_frames import extract_clip as jax_extract
    from cvd_tpu_torch.data import extract_frames

    root = tmp_path / "re10k"
    os.makedirs(root / "RealEstate10K" / "train")
    os.makedirs(root / "dataset" / "train")
    for c, clip in enumerate(["vidA", "vidB"]):
        write_pose_file(root / "RealEstate10K" / "train" / f"{clip}.txt", 9, seed=c)
        vw = cv2.VideoWriter(str(root / "dataset" / "train" / f"{clip}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 36))
        assert vw.isOpened(), "cv2 mp4 writer unavailable"
        for f in _smooth_frames(9):
            vw.write(f[..., ::-1])
        vw.release()
    write_pose_file(root / "RealEstate10K" / "train" / "noclip.txt", 3)   # no mp4: skipped
    extract_frames.main(["--root", str(root)])
    from PIL import Image

    pose, mp4 = (str(root / "RealEstate10K" / "train" / "vidA.txt"),
                 str(root / "dataset" / "train" / "vidA.mp4"))
    assert jax_extract(pose, mp4, str(tmp_path / "jax")) == 9
    for cid in range(100, 109):
        ours = np.asarray(Image.open(root / "dataset" / "train" / "vidA" / f"{cid}.png"))
        theirs = np.asarray(Image.open(tmp_path / "jax" / f"{cid}.png"))
        assert ours.shape == (36, 64, 3) and np.array_equal(ours, theirs)
    assert len(os.listdir(root / "dataset" / "train" / "vidB")) == 9
    assert not (root / "dataset" / "train" / "noclip").exists()
    # existing pngs are kept unless overwritten
    assert extract_frames.extract_clip(pose, mp4, str(root / "dataset" / "train" / "vidA")) == 0
    assert extract_frames.extract_clip(pose, mp4, str(root / "dataset" / "train" / "vidA"),
                                       overwrite=True) == 9

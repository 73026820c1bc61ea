"""``cvd_tpu_torch.cli.eval_parity`` against ``cvd_tpu.cli.eval_parity`` on
the same files: a png directory, a gif and ``.npy`` arrays (uint8 and float)
give equal JSON from both ``main``s, the exit code is 1 below the gate and a
shape mismatch stops both."""
import json
import os

import numpy as np
import pytest

from cvd_tpu.cli import eval_parity as jax_parity
from cvd_tpu_torch.cli import eval_parity


def _videos(seed=0, F=3, H=16, W=16):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (F, H, W, 3)).astype(np.uint8)
    noise = rng.integers(-10, 11, ref.shape)
    return ref, np.clip(ref.astype(np.int64) + noise, 0, 255).astype(np.uint8)


def _main(module, capsys, *argv):
    code = module.main(list(argv))
    out = capsys.readouterr().out
    return code, json.loads(out.strip().splitlines()[-1]) if "--json" in argv else out


def _write(tmp_path, kind, name, video):
    import imageio.v2 as imageio

    if kind == "npy_uint8":
        path = str(tmp_path / f"{name}.npy")
        np.save(path, video)
    elif kind == "npy_float":
        path = str(tmp_path / f"{name}.npy")
        np.save(path, video.astype(np.float32) / 255.0)
    elif kind == "png":
        path = str(tmp_path / name)
        os.makedirs(path)
        for i, frame in enumerate(video):
            imageio.imwrite(os.path.join(path, f"{i:04d}.png"), frame)
    else:
        path = str(tmp_path / f"{name}.gif")
        imageio.mimsave(path, list(video))
    return path


@pytest.mark.parametrize("kind", ["npy_uint8", "npy_float", "png", "gif"])
@pytest.mark.parametrize("threshold", ["20", "35"])
def test_same_json_as_cvd_tpu(kind, threshold, tmp_path, capsys):
    if kind in ("png", "gif"):
        pytest.importorskip("imageio")
    ref, test = _videos()
    paths = [_write(tmp_path, kind, n, v) for n, v in (("ref", ref), ("test", test))]
    argv = ("--ref", paths[0], "--test", paths[1], "--threshold_db", threshold, "--json")
    code, got = _main(eval_parity, capsys, *argv)
    jcode, want = _main(jax_parity, capsys, *argv)
    assert got == want and code == jcode
    # +-10 grey levels give ~32.6 dB (a gif's palette adds its own error): below 35
    assert got["frames"] == 3 and got["psnr_min_db"] < 35 and code == 1 - got["pass"]
    if kind != "gif":
        assert code == (0 if threshold == "20" else 1) and 30 < got["psnr_min_db"]


def test_identical_videos_and_a_shape_mismatch(tmp_path, capsys):
    ref, _ = _videos()
    a = _write(tmp_path, "npy_uint8", "a", ref)
    b = _write(tmp_path, "npy_uint8", "b", ref[:2])
    code, out = _main(eval_parity, capsys, "--ref", a, "--test", a)
    assert code == 0 and "inf" in out and "pass (>= 35.0 dB per frame): True" in out
    with pytest.raises(SystemExit, match="shape mismatch"):
        eval_parity.main(["--ref", a, "--test", b])
    assert eval_parity.psnr(ref / 255.0, ref / 255.0) == float("inf")
    x = np.random.default_rng(1).random((8, 8, 3))
    assert eval_parity.ssim(x, x) == pytest.approx(1.0)
    assert eval_parity.ssim(x, 1 - x) == jax_parity.ssim(x, 1 - x)

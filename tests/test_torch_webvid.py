"""Unposed (WebVid) and remote training data of cvd_tpu_torch against
cvd_tpu on the CPU: the homography pair-maker, WebVidFolded items from a
tiny PNG root, HybridDataset's choices, the remote datasets over file://
URLs, _fetch's retry / resume rules with a patched opener, the unposed train
step against cvd_tpu's, and the hybrid training CLI.

The train step: the JAX bundle is ``PipelineModules.create(...,
fast_init=True)`` with an image LoRA (rank 2) and the auxiliary q/k head,
every tensor drawn, converted with ``state_dict_from_flax``; the batch has
pre-encoded latents, H mats of random homographies and random warped masks;
the noise and timesteps are what JAX's step draws, and the pseudo-line
slopes are pinned on both sides (cvd_tpu's ``_uniform_slope`` patched for
the test, the port's ``slope``). Bars: loss to 1e-5 relative, trainable
gradients at >= 60 dB SNR.
"""
import dataclasses
import io
import json
import os
import random
import shutil
import sys
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
Fr, S = 2, 16   # frames, latent size
SLOPES = np.array([0.3, 1.1, 2.0, 2.9], np.float32)   # one per row of the [2 * Fr] batch


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _write_webvid(root, clips=(("c0", 5), ("c1", 4)), seed=0, caption=True):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for name, n in clips:
        os.makedirs(root / "videos" / name, exist_ok=True)
        for i in range(n):
            img = rng.integers(0, 256, (72, 88, 3), dtype=np.uint8)   # resize + crop run
            Image.fromarray(img).save(root / "videos" / name / f"{i:04d}.png")
    if caption:
        (root / "captions.json").write_text(json.dumps({clips[0][0]: "a dog on a beach"}))
    return root


@pytest.fixture(scope="module")
def webvid_root(tmp_path_factory):
    return _write_webvid(tmp_path_factory.mktemp("webvid"))


@pytest.fixture(scope="module")
def mp4_root(tmp_path_factory):
    """A RealEstate10K root with mp4 clips (the layout the remote dataset
    streams) and the pose file of assets/pose_files."""
    import cv2

    root = tmp_path_factory.mktemp("re10k_mp4")
    (root / "RealEstate10K" / "train").mkdir(parents=True)
    (root / "dataset" / "train").mkdir(parents=True)
    (root / "annotation_json").mkdir()
    rng = np.random.default_rng(1)
    captions = {}
    for clip in ("vidA", "vidB"):
        lines = open(os.path.join(ASSETS, "pose_files", "example_dolly.txt")).readlines()[:8]
        (root / "RealEstate10K" / "train" / f"{clip}.txt").write_text("".join(lines))
        vw = cv2.VideoWriter(str(root / "dataset" / "train" / f"{clip}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        assert vw.isOpened()
        for _ in range(7):
            vw.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        vw.release()
        captions[f"{clip}.mp4"] = [f"a tour of {clip}"]
    (root / "annotation_json" / "train_captions.json").write_text(json.dumps(captions))
    (root / "RealEstate10K" / "train" / "index.txt").write_text("vidA\nvidB\n")
    return root


# ------------------------------------------------------------ pair-making

def test_homography_functions_match_jax():
    from cvd_tpu.data import webvid as J

    from cvd_tpu_torch.data import webvid as T

    for seed in range(3):
        H = T.random_homography(random.Random(seed), 64)
        np.testing.assert_array_equal(H, J.random_homography(random.Random(seed), 64))
        img = np.random.default_rng(seed).uniform(-1, 1, (64, 64, 3)).astype(np.float32)
        (w, m), (jw, jm) = T.warp_homography(img, H), J.warp_homography(img, H)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(m, jm)
        assert 0 < m.mean() < 1
        masks = np.stack([m, m[::-1]])
        np.testing.assert_array_equal(T.min_pool_mask(masks), J.min_pool_mask(masks))


def test_webvid_items_match_jax(webvid_root):
    """Same root and seed: every item equal to cvd_tpu's, bit for bit (PIL
    decodes, the rng draws the start frame and then the homography)."""
    from cvd_tpu.data.webvid import WebVidFolded as JaxWebVid

    from cvd_tpu_torch.data.webvid import WebVidFolded

    ds, ref = WebVidFolded(str(webvid_root), 3, 32, seed=4), JaxWebVid(str(webvid_root), 3, 32,
                                                                        seed=4)
    assert len(ds) == len(ref) == 2
    for i in (0, 1, 0):
        got, want = ds[i], ref[i]
        assert set(got) == set(want) == {"pixel_values", "text", "H_mats", "warped_masks"}
        for k in ("pixel_values", "H_mats", "warped_masks"):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
        assert got["text"] == want["text"]
    item = ds[1]
    assert item["text"] == "c1"   # no caption: the clip's name
    assert item["pixel_values"].shape == (6, 32, 32, 3) and item["warped_masks"].shape == (
        6, 4, 4, 1)
    np.testing.assert_allclose(item["H_mats"][0] @ item["H_mats"][3], np.eye(3), atol=1e-5)


def test_homography_pair_of_seeded_frames():
    """The pair-maker alone (what a source of frames in memory uses): the
    first view unmasked, the second the warp of the first."""
    from cvd_tpu_torch.data.webvid import homography_pair, warp_homography

    frames = np.random.default_rng(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    pair = homography_pair(frames, random.Random(2))
    H = pair["H_mats"][0].astype(np.float64)
    assert (pair["warped_masks"][:3] == 1).all()
    np.testing.assert_array_equal(pair["pixel_values"][:3], frames)
    warped, _ = warp_homography(frames[1], np.array(H))
    np.testing.assert_allclose(pair["pixel_values"][4], warped, atol=1e-6)


def test_hybrid_dataset_choices_match_jax():
    from cvd_tpu.data.webvid import HybridDataset as JaxHybrid

    from cvd_tpu_torch.data.webvid import HybridDataset

    class Tagged:
        def __init__(self, tag, n):
            self.tag, self.n = tag, n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return (self.tag, i)

    a, b = Tagged("a", 3), Tagged("b", 5)
    mine, ref = HybridDataset(a, b, 0.3, seed=9, length=40), JaxHybrid(a, b, 0.3, seed=9,
                                                                        length=40)
    got, want = [mine[i] for i in range(40)], [ref[i] for i in range(40)]
    assert got == want and {t for t, _ in got} == {"a", "b"}
    assert len(HybridDataset(a, b)) == 8


# ------------------------------------------------------------------ remote

def test_remote_datasets_over_file_urls_equal_local(mp4_root, webvid_root, tmp_path):
    """Streamed through file:// into a cache, the items equal the local
    datasets' (same seed) and cvd_tpu's remote ones; a second look reads
    the cache and the one local dataset grew in place."""
    from cvd_tpu.data.remote import RealEstate10KPoseFoldedRemote as JaxRe10k
    from cvd_tpu.data.remote import WebVid10MRemote as JaxWebVid

    from cvd_tpu_torch.data.realestate10k import RealEstate10KPoseFolded
    from cvd_tpu_torch.data.remote import RealEstate10KPoseFoldedRemote, WebVid10MRemote
    from cvd_tpu_torch.data.webvid import WebVidFolded

    kw = dict(sample_stride=1, sample_n_frames=2, sample_size=32, seed=0)
    remote = RealEstate10KPoseFoldedRemote("file://" + str(mp4_root), str(tmp_path / "r"), **kw)
    local = RealEstate10KPoseFolded(str(mp4_root), **kw)
    ref = JaxRe10k("file://" + str(mp4_root), str(tmp_path / "rj"), **kw)
    assert len(remote) == 2
    for i in (0, 1, 0):
        got, want, jax_item = remote[i], local[i], ref[i]
        for k in ("pixel_values", "plucker_embedding", "F_mats"):
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_allclose(got[k], jax_item[k], atol=1e-5)
        assert got["text"] == want["text"] == jax_item["text"]
    assert [e["clip_name"] for e in remote._local.dataset] == ["vidA", "vidB"]

    wroot = tmp_path / "wsrc"
    shutil.copytree(webvid_root, wroot)
    (wroot / "index.txt").write_text("c0 5\nc1 4\n")
    wkw = dict(sample_n_frames=3, sample_size=32, seed=1)
    wremote = WebVid10MRemote("file://" + str(wroot), str(tmp_path / "w"), **wkw)
    wlocal = WebVidFolded(str(wroot), **wkw)
    wref = JaxWebVid("file://" + str(wroot), str(tmp_path / "wj"), **wkw)
    for i in (0, 1):
        got, want, jax_item = wremote[i], wlocal[i], wref[i]
        for k in ("pixel_values", "H_mats", "warped_masks"):
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], jax_item[k])
        assert got["text"] == want["text"]
    assert len(wremote._local.clips) == 2


class _Response(io.BytesIO):
    def __init__(self, data, status=200):
        super().__init__(data)
        self.status = status

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


PAYLOAD = b"0123456789abcdef"


@pytest.mark.parametrize("case", ["transient_then_ok", "resume", "refused_range",
                                  "hard_404", "always_503"])
def test_fetch_retries_resumes_and_fails_fast(case, tmp_path, monkeypatch):
    """``_fetch``: a transient failure retries (auth headers on every
    attempt); a partial ``.tmp`` resumes with a Range request and appends a
    206; a refused Range (416) drops the partial and starts clean; a hard
    404 fails at once; a failure that lasts raises after FETCH_ATTEMPTS."""
    from cvd_tpu_torch.data import remote as R

    monkeypatch.setattr(R, "BACKOFF_SECONDS", 0.001)
    monkeypatch.setenv("CVD_TPU_REMOTE_TOKEN", "sekrit")
    monkeypatch.setenv("CVD_TPU_REMOTE_HEADERS", json.dumps({"X-Team": "cvd"}))
    dest = tmp_path / "out.bin"
    seen = []

    def opener(req, *a, **kw):
        headers = dict(req.header_items())
        seen.append(headers)
        n = len(seen)
        if case == "transient_then_ok" and n == 1:
            raise urllib.error.URLError("connection reset")
        if case == "resume":
            assert headers.get("Range") == "bytes=6-"
            return _Response(PAYLOAD[6:], status=206)
        if case == "refused_range" and n == 1:
            assert headers.get("Range") == "bytes=6-"
            raise urllib.error.HTTPError(req.full_url, 416, "range", {}, None)
        if case == "hard_404":
            raise urllib.error.HTTPError(req.full_url, 404, "nope", {}, None)
        if case == "always_503":
            raise urllib.error.HTTPError(req.full_url, 503, "busy", {}, None)
        return _Response(PAYLOAD)

    if case in ("resume", "refused_range"):
        (tmp_path / "out.bin.tmp").write_bytes(PAYLOAD[:6])
    with mock.patch.object(urllib.request, "urlopen", opener):
        if case == "hard_404":
            with pytest.raises(urllib.error.HTTPError):
                R._fetch("https://example.com/a.bin", str(dest))
        elif case == "always_503":
            with pytest.raises(IOError, match="after 3 attempts"):
                R._fetch("https://example.com/a.bin", str(dest))
        else:
            assert R._fetch("https://example.com/a.bin", str(dest)) == str(dest)
            assert dest.read_bytes() == PAYLOAD and not (tmp_path / "out.bin.tmp").exists()
            # cached: no further request
            assert R._fetch("https://example.com/a.bin", str(dest)) == str(dest)
    want = {"transient_then_ok": 2, "resume": 1, "refused_range": 2, "hard_404": 1,
            "always_503": R.FETCH_ATTEMPTS}[case]
    assert len(seen) == want
    assert all(h.get("Authorization") == "Bearer sekrit" and h.get("X-team") == "cvd"
               for h in seen)


# ------------------------------------------------- the unposed train step

def _unposed_batch(seed=0):
    from cvd_tpu_torch.data.webvid import random_homography

    rng = np.random.default_rng(seed)
    H = random_homography(random.Random(seed), 8 * S)
    H_mats = np.stack([H] * Fr + [np.linalg.inv(H)] * Fr).astype(np.float32)
    return {
        "latents": rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32),
        "text_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32),
        "H_mats": H_mats.reshape(2, Fr, 3, 3),
        "warped_masks": (rng.random((2, Fr, S, S, 1)) > 0.3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_bundle():
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    from cvd_tpu.pipelines.common import PipelineModules

    cfg = dataclasses.replace(TINY_UNET, spatial_lora_rank=2, additional_channel=4)
    return PipelineModules.create(unet_config=cfg, vae_config=TINY_VAE, clip_config=TINY_CLIP,
                                  latent_size=S, video_length=Fr, fast_init=True)


@pytest.fixture(scope="module")
def jax_step(jax_bundle):
    """cvd_tpu's unposed step with its slopes pinned to SLOPES: (loss,
    epi_loss, gradients), and the noise / timesteps it drew."""
    import optax

    from cvd_tpu.models import epi as jax_epi
    from cvd_tpu.train.state import TrainState
    from cvd_tpu.train.train_step import train_step

    jm = jax_bundle
    # the update is zero and the new optimizer state is the gradient itself
    tx = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    key = jax.random.key(11)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jm.unet_params,
                       opt_state=tx.init(jm.unet_params), tx=tx)
    batch = {k: jnp.asarray(v) for k, v in _unposed_batch().items()}

    def pinned(rng, shape):
        assert shape == SLOPES.shape, shape    # one slope per row
        return jnp.asarray(SLOPES)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_epi, "_uniform_slope", pinned)
        new_state, metrics = jax.jit(lambda s, b, k: train_step(
            s, b, jm, k, use_flash_kernel=False, remat=False))(state, batch, key)
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state)
    _, eps_key, t_key, _, _ = jax.random.split(key, 5)
    noise = np.asarray(jax.random.normal(eps_key, (2, Fr, S, S, 4), jnp.float32))
    timesteps = np.asarray(jax.random.randint(t_key, (2,), 0, 1000))
    return float(metrics["loss"]), float(metrics["epi_loss"]), grads, noise, timesteps


def _port_modules(jm):
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.pipelines.common import PipelineModules

    cfg = dataclasses.replace(SMOKE_UNET, spatial_lora_rank=2, additional_channel=4)
    m = PipelineModules.create(cfg, SMOKE_VAE, SMOKE_CLIP, device="cpu")
    m.unet.load_state_dict(state_dict_from_flax(jm.unet_params), strict=True)
    m.clip.load_state_dict(state_dict_from_flax(jm.clip_params), strict=True)
    return m


@pytest.mark.parametrize("remat", [False, True])
def test_unposed_train_step_matches_jax(jax_bundle, jax_step, remat):
    """No pose features, the image LoRA at scale 0, lines from the H mats
    with one slope per row, the MSE masked by the warped masks, no epipolar
    loss (no F mats): cvd_tpu's loss and gradients."""
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    want_loss, want_epi, want_grads, noise, timesteps = jax_step
    m = _port_modules(jax_bundle)
    assert any(".to_q_lora.up." in n and p.abs().sum() > 0 for n, p in m.unet.named_parameters())
    state = create_train_state(m.unet)
    batch = {k: torch.from_numpy(v) for k, v in _unposed_batch().items()}
    loss, epi = loss_and_grads(state, batch, m, noise=torch.tensor(noise),
                               timesteps=torch.tensor(timesteps),
                               slope=torch.from_numpy(SLOPES), remat=remat)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert float(epi) == want_epi == 0.0
    want = state_dict_from_flax(want_grads)
    params = dict(m.unet.named_parameters())
    got = np.concatenate([params[n].grad.numpy().ravel() for n in state.trainable])
    ref = np.concatenate([want[n].numpy().ravel() for n in state.trainable])
    assert _snr_db(got, ref) >= 60.0, f"gradient SNR {_snr_db(got, ref):.1f} dB"
    # the auxiliary head takes no part without F mats: a zero gradient on both
    # sides, which AdamW still decays
    head = [n for n in state.trainable if "auxiliary" in n]
    assert head and all(not params[n].grad.any() and not want[n].any() for n in head)


def test_unposed_step_draws_one_slope_per_row_once(monkeypatch):
    """Every epi attention of a step, remat replays included, builds its
    lines from the same [B * F] slopes, drawn once per step."""
    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.models import epi
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.train.state import create_train_state
    from cvd_tpu_torch.train.train_step import loss_and_grads

    seen = []
    real = epi.homography_lines

    def spy(H_mats, coords, size, slope):
        seen.append(slope.clone())
        return real(H_mats, coords, size, slope)

    monkeypatch.setattr(epi, "homography_lines", spy)
    m = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0), random_full=True)
    state = create_train_state(m.unet)
    batch = {k: torch.from_numpy(v) for k, v in _unposed_batch(3).items()}
    loss_and_grads(state, batch, m, torch.Generator().manual_seed(1), remat=True)
    n_epi = sum(1 for n, _ in m.unet.named_modules() if n.endswith("attention_blocks.0"))
    assert len(seen) >= 2 * n_epi     # forward and the block remat replays
    assert seen[0].shape == (2 * Fr,) and len(set(seen[0].tolist())) == 2 * Fr
    assert all(torch.equal(s, seen[0]) for s in seen)
    assert ((seen[0] >= 0) & (seen[0] < np.pi)).all()


# ------------------------------------------------------------ hybrid CLI

class _Frames:
    """In-memory unposed source: seeded frames through the pair-maker."""

    def __init__(self, n_items, n_frames=2, size=64):
        self.n_items, self.n_frames, self.size = n_items, n_frames, size

    def __len__(self):
        return self.n_items

    def __getitem__(self, i):
        from cvd_tpu_torch.data.webvid import homography_pair

        rng = np.random.default_rng(100 + int(i))
        frames = rng.uniform(-1, 1, (self.n_frames, self.size, self.size, 3)).astype(np.float32)
        return {**homography_pair(frames, random.Random(int(i))), "text": f"clip {i}"}


def _jax_kinds(seed, weights, steps, primary_len):
    """cvd_tpu/cli/train.py:348-363, 409: the kinds drawn and the epoch."""
    rng, kinds, draws = random.Random(seed + 1), [], 0
    for _ in range(steps):
        r, acc = rng.random(), 0.0
        for i, w in enumerate(weights):
            acc += w
            if r < acc:
                break
        kinds.append(i)
        draws += i == 0
    return kinds, draws // primary_len


def test_hybrid_run_draws_cvd_tpus_kinds_and_caches_posed_only(tmp_path):
    from test_torch_train_extras import _Pairs

    from cvd_tpu_torch.cli import train

    cfg = dict(random_weights=True, device="cpu", sample_size=64, sample_n_frames=2,
               max_train_steps=7, checkpointing_steps=100, num_workers=1, logger_interval=1,
               global_seed=3, do_sanity_check=True, output_dir=str(tmp_path / "run"),
               cache_latents=True, latents_cache_dir=str(tmp_path / "cache"),
               latents_cache_items=2)
    out = train.run(cfg, sources=[("posed", _Pairs(n_items=3), 0.4),
                                  ("unposed", _Frames(n_items=2), 0.6)])
    kinds, epoch = _jax_kinds(3, (0.4, 0.6), 7, primary_len=2)
    assert [("posed", "unposed")[k] for k in kinds] == out["kinds"]
    assert set(out["kinds"]) == {"posed", "unposed"} and out["epoch"] == epoch
    assert np.isfinite(out["losses"]).all() and out["global_step"] == 7
    # the cache holds the posed source's first 2 items, and nothing unposed
    assert out["latents_cache"]["items"] == 2
    assert sorted(os.listdir(tmp_path / "cache")) == ["item-000000.npz", "item-000001.npz",
                                                      "manifest.json"]
    # the first step came from the cache: no pixels, no sanity dump
    assert out["kinds"][0] == "posed" and not (tmp_path / "run" / "sanity_check").exists()


def test_hybrid_config_from_disk_and_unknown_names(tmp_path, webvid_root):
    """``dataset_name: hybrid`` over a RealEstate10K root and a WebVid root
    (``webvid10m`` alone too, with its sanity dump); an unknown name exits
    before a build."""

    from cvd_tpu_torch.cli import train

    re10k = _write_re10k(tmp_path / "re10k")
    base = dict(random_weights=True, device="cpu", sample_size=64, sample_n_frames=2,
                max_train_steps=3, checkpointing_steps=100, num_workers=1, global_seed=1,
                do_sanity_check=False)
    out = train.run(dict(base, output_dir=str(tmp_path / "h"), train_data=dict(
        dataset_name="hybrid", posed_ratio=0.5, realestate10k=dict(root_path=str(re10k)),
        webvid10m=dict(root_path=str(webvid_root)))))
    kinds, _ = _jax_kinds(1, (0.5, 0.5), 3, primary_len=1)
    assert out["kinds"] == [("posed", "unposed")[k] for k in kinds]
    out = train.run(dict(base, output_dir=str(tmp_path / "w"), max_train_steps=1,
                         do_sanity_check=True, train_data=dict(dataset_name="webvid10m",
                                                               root_path=str(webvid_root))))
    assert out["kinds"] == ["unposed"] and np.isfinite(out["losses"]).all()
    # the first step's sanity overlay, from its H mats
    assert (tmp_path / "w" / "sanity_check" / "epi_overlay.npy").exists()
    with pytest.raises(SystemExit, match="kinetics"):
        train.run(dict(base, output_dir=str(tmp_path / "x"),
                       train_data=dict(dataset_name="kinetics", root_path="/nonexistent")))
    assert not (tmp_path / "x").exists()


def _write_re10k(root):
    """A RealEstate10K root of one clip with PNG frames (the pose file of
    assets/pose_files, seeded frames)."""
    from PIL import Image

    from cvd_tpu_torch.geometry.cameras import parse_pose_file

    clip = "example_dolly"
    (root / "RealEstate10K" / "train").mkdir(parents=True)
    (root / "dataset" / "train" / clip).mkdir(parents=True)
    (root / "annotation_json").mkdir()
    pose_file = os.path.join(ASSETS, "pose_files", f"{clip}.txt")
    shutil.copy(pose_file, root / "RealEstate10K" / "train" / f"{clip}.txt")
    rng = np.random.default_rng(0)
    for cam in parse_pose_file(pose_file):
        Image.fromarray(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)).save(
            root / "dataset" / "train" / clip / f"{int(cam.cid)}.png")
    (root / "annotation_json" / "train_captions.json").write_text(
        json.dumps({f"{clip}.mp4": ["a quiet living room"]}))
    return root

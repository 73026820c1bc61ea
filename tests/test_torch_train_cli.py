"""The port's training CLI as a user runs it, on the CPU: tiny random
weights, 64 px, 2 frames, 2 steps, on a RealEstate10K-layout dataset
written from a seed (a copy of assets/pose_files/example_dolly.txt, seeded
80x64 PNG frames so resize and crop run, and the captions file). Also the
dataset reader and loader, checkpoints against cvd_tpu's export keys,
resume, the training options and the ones that are refused."""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(__file__))
torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
CLIP = "example_dolly"


@pytest.fixture(scope="module")
def re10k_root(tmp_path_factory):
    from PIL import Image

    from cvd_tpu_torch.geometry.cameras import parse_pose_file

    root = tmp_path_factory.mktemp("re10k")
    pose_dir = root / "RealEstate10K" / "train"
    frame_dir = root / "dataset" / "train" / CLIP
    pose_dir.mkdir(parents=True)
    frame_dir.mkdir(parents=True)
    pose_file = os.path.join(ASSETS, "pose_files", f"{CLIP}.txt")
    shutil.copy(pose_file, pose_dir / f"{CLIP}.txt")
    rng = np.random.default_rng(0)
    for cam in parse_pose_file(pose_file):
        img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)   # H 64, W 80
        Image.fromarray(img).save(frame_dir / f"{int(cam.cid)}.png")
    (root / "annotation_json").mkdir()
    with open(root / "annotation_json" / "train_captions.json", "w") as f:
        json.dump({f"{CLIP}.mp4": ["a quiet living room, slow dolly"]}, f)
    return root


@pytest.fixture(scope="module")
def webvid_root(tmp_path_factory):
    from test_torch_webvid import _write_webvid

    return _write_webvid(tmp_path_factory.mktemp("webvid"))


def _config(tmp_path, root, **kw):
    cfg = dict(
        output_dir=str(tmp_path / "run"), random_weights=True, bf16=False, device="cpu",
        train_data=dict(root_path=str(root), sample_stride=2), sample_size=64,
        sample_n_frames=2, train_batch_size=1, num_workers=2, max_train_steps=2,
        checkpointing_steps=2, logger_interval=1, learning_rate=1e-3, global_seed=3,
        do_sanity_check=True)
    cfg.update(kw)
    return cfg


def _write(tmp_path, cfg, name="train.yaml"):
    path = tmp_path / name
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_realestate10k_folded_sample(re10k_root):
    from cvd_tpu_torch.data.realestate10k import RealEstate10KPoseFolded

    ds = RealEstate10KPoseFolded(str(re10k_root), sample_n_frames=2, sample_size=64, seed=0)
    assert len(ds) == 1
    s = ds[0]
    assert s["pixel_values"].shape == (4, 64, 64, 3)
    assert -1.0 <= s["pixel_values"].min() and s["pixel_values"].max() <= 1.0
    assert s["plucker_embedding"].shape == (4, 64, 64, 6)
    assert s["F_mats"].shape == (4, 3, 3) and np.isfinite(s["F_mats"]).all()
    assert s["text"] == "a quiet living room, slow dolly"
    # the folded pair shares its start frame: identity relative pose
    np.testing.assert_allclose(s["ret_c2w"][0], np.eye(4), atol=1e-5)
    np.testing.assert_allclose(s["ret_c2w"][2], np.eye(4), atol=1e-5)


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_data_loader_batches_with_thread_and_process_workers(worker_type):
    """Both worker types batch a list of samples alike (process workers under
    a time limit: tests/test_torch_multihost.py's ``_within``)."""
    from test_torch_multihost import _within

    from cvd_tpu_torch.data.loader import DataLoader

    data = [{"x": np.full((2,), i, np.float32), "text": str(i)} for i in range(5)]
    loader = DataLoader(data, batch_size=2, num_workers=2, seed=1, worker_type=worker_type)
    batches = _within(60, lambda: list(loader))
    assert len(loader) == len(batches) == 2
    assert all(b["x"].shape == (2, 2) and len(b["text"]) == 2 for b in batches)
    seen = np.concatenate([b["x"][:, 0] for b in batches])
    assert len(set(seen.tolist())) == 4


def test_train_cli_runs_saves_and_resumes(tmp_path, re10k_root):
    from cvd_tpu.io.key_mapping import export_torch_state
    from cvd_tpu.pipelines.common import abstract_param_shapes
    from cvd_tpu.train.state import trainable_mask
    from flax import traverse_util
    from tiny import TINY_UNET

    from cvd_tpu_torch.cli import train

    cfg = _config(tmp_path, re10k_root)
    out = train.main(["--config", _write(tmp_path, cfg)])
    assert out["global_step"] == 2 and out["state"].step == 2
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    run = tmp_path / "run"
    ck = run / "checkpoints"
    assert (ck / "step-2.pt").exists()
    assert (run / "sanity_check" / "epi_overlay.npy").exists()
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
    with open(run / "config.yaml") as f:    # the snapshot of what the run was asked for
        assert yaml.safe_load(f) == cfg

    # the reference-format checkpoint: cvd_tpu's export keys and shapes for
    # the same (tiny) UNet's trainable subset
    ref = torch.load(ck / "checkpoint-step-2.ckpt", weights_only=True)
    assert ref["global_step"] == 2 and ref["epoch"] == 1  # passes completed before step 2
    shapes = abstract_param_shapes(unet_config=TINY_UNET, latent_size=8,
                                   video_length=2)["unet"]
    flat = traverse_util.flatten_dict(shapes["params"])
    mask = traverse_util.flatten_dict(trainable_mask(shapes)["params"])
    trainable = traverse_util.unflatten_dict(
        {k: np.zeros(v.shape, np.float32) for k, v in flat.items() if mask[k]})
    want = export_torch_state(trainable)
    got = ref["unet_trainable_dict"]
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in want)
    params = dict(out["state"].model.named_parameters())
    assert all(torch.equal(got[k], params[k].detach()) for k in got)

    # resume: continues at step 2 with the saved weights and optimizer
    cfg2 = _config(tmp_path, re10k_root, max_train_steps=3, checkpointing_steps=100,
                   resume_from=str(ck / "step-2.pt"), do_sanity_check=False,
                   output_dir=str(tmp_path / "resumed"))
    out2 = train.run(cfg2)
    assert out2["global_step"] == 3 and out2["state"].step == 3 and len(out2["losses"]) == 1
    opt = out2["state"].optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 3 for s in opt.values())


PORTED = ("sync_lora_rank", "epi_loss_weight", "lora_rank", "sync_lora_scale",
          "cache_latents", "validation_steps", "validation_data", "train_data",
          "remat_policy", "worker_type")


@pytest.mark.parametrize("override", [
    {"train_data": {"dataset_name": "webvid10m"}},
    {"cache_latents": True},
    {"validation_steps": 10},
    {"sync_lora_rank": 4},
    {"remat_policy": "dots", "remat": True},
    {"random_weights": False},
    {"epi_loss_weight": 0.002},
    {"lora_rank": 4},
    {"sync_lora_scale": 0.5},
    {"validation_data": {"pose_file_0": "a.txt", "pose_file_1": "b.txt"}},
    {"worker_type": "process"},
    {"remat_policy": "dots"},
    {"civitai_lora_ckpt": "/nonexistent/lora.safetensors"},
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items())[:60])
def test_training_options_are_taken_or_refused(tmp_path, re10k_root, webvid_root, override):
    """An option of PORTED is taken: one step runs, with the sync-LoRA in the
    trainable set where a rank asks for it (lora_rank alone is the image
    LoRA's rank, which needs its file; epi_loss_weight weighs a loss no
    config with additional_channel 0 has; a sync scale without a rank is
    off), as in cvd_tpu; the latents cache is built and trained from;
    validation every 10 steps does not run in one step, and its data alone
    is read only when it runs; WebVid data gives an unposed step; remat_policy
    with remat on is taken (without it, it is refused: it would do nothing);
    process workers load the step. Without random weights the build asks for
    checkpoints; a civitai option is a weight file, which random weights
    refuse as they refuse every weight option (it would be ignored)."""
    from test_torch_multihost import _within

    from cvd_tpu_torch.cli import train

    key = next(iter(override))
    if key in PORTED and override != {"remat_policy": "dots"}:
        if key == "train_data":
            override = {"train_data": dict(override["train_data"], root_path=str(webvid_root))}
        cfg = _config(tmp_path, re10k_root, max_train_steps=1, checkpointing_steps=10,
                      do_sanity_check=False, **override)
        out = _within(120, lambda: train.run(cfg))     # process workers fork
        assert out["kinds"] == ["unposed" if key == "train_data" else "posed"]
        assert out["modules"].unet.config.remat_policy == override.get("remat_policy", "")
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
        sync = [n for n in out["state"].trainable if "_lora_sync." in n]
        assert bool(sync) == (key == "sync_lora_rank")
        cache = out["latents_cache"]
        assert (cache is not None and cache["built"] and cache["items"] == 1) == (
            key == "cache_latents")
        assert not (tmp_path / "run" / "validation").exists()
        return
    cfg = _config(tmp_path, "/nonexistent")
    cfg.update(override)
    with pytest.raises(ValueError):
        train.run(cfg)


def test_options_at_their_off_value_are_taken(tmp_path):
    from cvd_tpu_torch.cli import train

    train._refuse_unported(_config(tmp_path, "/nonexistent", epi_loss_weight=0.0, lora_rank=0,
                                   sync_lora_rank=0, sync_lora_scale=1.0, validation_data=None,
                                   validation_steps=0))


def test_the_shipped_train_config_runs_a_step(tmp_path, re10k_root):
    """configs/train_epi.yaml as shipped (epi_loss_weight 0.002, lora_rank 4),
    with random weights on the CPU at the smoke widths and the pose-file
    data: one step, whose loss equals bit for bit the one with both keys at
    0, as cvd_tpu's does (neither acts without an image-LoRA file and an
    auxiliary head)."""
    from cvd_tpu_torch.cli import train

    shipped = train.load_config(os.path.join(os.path.dirname(ASSETS), "configs",
                                             "train_epi.yaml"))
    assert shipped["epi_loss_weight"] == 0.002 and shipped["lora_rank"] == 4
    losses = []
    for name, keys in (("shipped", {}), ("off", {"epi_loss_weight": 0.0, "lora_rank": 0})):
        cfg = dict(shipped, **keys, random_weights=True, device="cpu", sample_size=64,
                   sample_n_frames=2, max_train_steps=1, checkpointing_steps=10,
                   num_workers=1, do_sanity_check=False, output_dir=str(tmp_path / name),
                   train_data=dict(shipped["train_data"], root_path=str(re10k_root)))
        out = train.run(cfg)
        losses.append(out["losses"][0])
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_frozen_weights_default_to_bfloat16():
    """As cvd_tpu's cli/train.py:259: bfloat16 whatever ``bf16`` says."""
    from cvd_tpu_torch.cli.train import _frozen_dtype

    assert _frozen_dtype({}) == torch.bfloat16
    assert _frozen_dtype({"bf16": False}) == torch.bfloat16
    assert _frozen_dtype({"frozen_weights_dtype": "float32", "bf16": True}) == torch.float32


def test_multihost_takes_torchruns_group(tmp_path, re10k_root, monkeypatch):
    """``--multihost`` as a world of one over gloo (torchrun's environment
    set by hand): two steps, the process group gone after the run (under a
    time limit: a process group that waits for a peer fails the test)."""
    import socket

    import torch.distributed as dist
    from test_torch_multihost import _within

    from cvd_tpu_torch.cli import train

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    argv = ["--config", _write(tmp_path, _config(tmp_path, re10k_root, do_sanity_check=False)),
            "--multihost"]
    out = _within(120, lambda: train.main(argv))
    assert (out["rank"], out["world_size"], len(out["losses"])) == (0, 1, 2)
    assert np.isfinite(out["losses"]).all() and not dist.is_initialized()


def test_unposed_batches_train(tmp_path):
    """A folded unposed batch (H mats and warped masks, no Plücker maps)
    trains: finite loss, the epi weights moved."""
    from test_torch_webvid import _Frames

    from cvd_tpu_torch.cli import train

    out = train.run(dict(random_weights=True, device="cpu", sample_size=64, sample_n_frames=2,
                         max_train_steps=1, num_workers=1, checkpointing_steps=10,
                         do_sanity_check=False, output_dir=str(tmp_path / "run")),
                    sources=[("unposed", _Frames(2), 1.0)])
    assert out["kinds"] == ["unposed"] and np.isfinite(out["losses"]).all()


def test_train_run_refuses_a_silent_cpu_run(monkeypatch, tmp_path, re10k_root):
    """No card and no ``device`` in the config: ``run`` raises, before it
    creates the output directory; ``device: cpu`` is taken (the tests above)."""
    from cvd_tpu_torch.cli import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path, re10k_root)
    del cfg["device"]
    with pytest.raises(RuntimeError, match="device: cpu"):
        train.run(cfg)
    assert not os.path.exists(cfg["output_dir"])

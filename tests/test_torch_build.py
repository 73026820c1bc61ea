"""``cvd_tpu_torch.cli.build`` past its random-weights branch, and the three
entry points built from checkpoint files, on the CPU at the smoke widths
(``widths=SMOKE_WIDTHS``; the files are
``test_torch_checkpoints.write_tiny_checkpoints``'s, in the released
layouts). Also what a load must leave right: the f32 masters of training and
the LayerNorm-fold cache of kernel K5."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_checkpoints import model_args, perturbed, write_tiny_checkpoints  # noqa: E402

from cvd_tpu_torch.cli.build import SMOKE_WIDTHS  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
MODEL_CONFIG = os.path.join(REPO, "configs", "inference_config.yaml")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    from tiny import tiny_modules

    base = tiny_modules(latent_size=8, video_length=2)
    return write_tiny_checkpoints(
        tmp_path_factory.mktemp("ckpt"), perturbed(base.unet_params, 10),
        perturbed(base.vae_params, 11), perturbed(base.clip_params, 12),
        perturbed(base.pose_encoder_params, 13))


def _tokenizer():
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    return HashTokenizer()


def _build(paths, **kw):
    from cvd_tpu_torch.cli.build import build_modules

    return build_modules(model_args(paths, **kw), torch.device("cpu"), tokenizer=_tokenizer(),
                         widths=SMOKE_WIDTHS)[0]


# ------------------------------------------------------------- build_modules

def test_without_an_epi_checkpoint_the_epi_modules_are_the_identity(paths):
    """A checkpoint build starts from the default initialization: what no
    file fills is the reference's fresh module, never uninitialized memory."""
    from cvd_tpu_torch.models.epi import EpiConditioning

    with_epi = _build(paths)
    without = _build(paths, epi_module_ckpt=None)
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((2, 2, 8, 8, 32)).astype(np.float32))
    cond = EpiConditioning(
        F_mats=torch.from_numpy((rng.standard_normal((4, 3, 3)) * 1e-3).astype(np.float32)),
        video_length=2, rand_slope_ff=False)
    with torch.no_grad():
        assert torch.equal(without.unet.down_blocks[0].epi_modules[0](x, cond), x)
        assert not torch.equal(with_epi.unet.down_blocks[0].epi_modules[0](x, cond), x)
    a, b = with_epi.unet.state_dict(), without.unet.state_dict()
    for key in a:
        assert torch.isfinite(b[key]).all(), key
        if "epi_modules" not in key:
            assert torch.equal(a[key], b[key]), key
    assert not any(b[k].any() for k in b if k.endswith("epi_transformer.proj_out.weight"))
    # without the pose adaptor the merge layers stay zero too
    no_pose = _build(paths, pose_adaptor_ckpt=None).unet.state_dict()
    assert not any(no_pose[k].any() for k in no_pose if "qkv_merge" in k)


def test_model_config_and_pose_scale_reach_the_modules(paths):
    m = _build(paths, model_config=MODEL_CONFIG, pose_adaptor_scale=0.25)
    assert m.unet.config.pose_scale == 0.25
    assert m.unet.config.block_out_channels == (32, 64, 64, 64)
    assert m.scheduler.beta_schedule == "linear" and not m.scheduler.clip_sample
    assert m.unet.config.motion_pe_max_len == 32


def test_bf16_build_rounds_each_file_tensor_once(paths):
    from cvd_tpu_torch.io.torch_io import load_torch_state

    m = _build(paths, bf16=True)
    epi = load_torch_state(paths["epi_module_ckpt"], "unet_trainable_dict")
    got = m.unet.state_dict()
    assert all(got[k].dtype == torch.bfloat16 and torch.equal(got[k], v.to(torch.bfloat16))
               for k, v in epi.items())
    assert next(m.vae.parameters()).dtype == torch.bfloat16


REFUSED = [
    dict(image_lora_ckpt="/nonexistent/lora.ckpt"),
    dict(image_lora_rank=4),
    dict(civitai_base_model="/nonexistent/model.safetensors"),
    dict(civitai_lora_ckpt="/nonexistent/lora.safetensors"),
    dict(controlnet_ckpt="/nonexistent/sparsectrl.ckpt"),
    dict(controlnet_simplified_embedding=True),
    dict(sync_lora_rank=4),
    dict(sync_lora_scale=0.0),
    dict(spatial_extended_attention=True),
    dict(remat_policy="dots"),
]
NOWHERE = dict(ori_model_path="/nonexistent/sd", motion_module_ckpt="/nonexistent/mm.ckpt",
               epi_module_ckpt="/nonexistent/epi.ckpt", pose_adaptor_ckpt="/nonexistent/p.ckpt")


# the options of REFUSED that are ported now: each is taken, and reaches the model
PORTED = ("image_lora_ckpt", "image_lora_rank", "sync_lora_rank", "sync_lora_scale",
          "spatial_extended_attention", "controlnet_ckpt", "controlnet_simplified_embedding",
          "remat_policy", "civitai_base_model", "civitai_lora_ckpt")


@pytest.fixture(scope="module")
def civitai(tmp_path_factory):
    """A tiny civitai model and kohya LoRA (``test_torch_ldm_convert``'s):
    (model path, LoRA path, {module: {key: tensor}} the model holds)."""
    from test_torch_ldm_convert import write_tiny_civitai

    model, lora, _, values = write_tiny_civitai(tmp_path_factory.mktemp("civitai"), seed=1)
    return model, lora, values


def _check_ported(paths, tmp_path, name, value, civitai):
    """Build from the tiny files with the option; what it must have set."""
    from cvd_tpu_torch.models.unet import UNet3DConditionModel

    if name.startswith("civitai_"):
        model, lora, values = civitai
        value = model if name == "civitai_base_model" else lora
        plain = _build(paths).unet.state_dict()
    if name == "image_lora_ckpt":
        with torch.device("meta"):
            shapes = UNet3DConditionModel(dataclasses.replace(
                SMOKE_WIDTHS[0], spatial_lora_rank=-2)).state_dict()
        g = torch.Generator().manual_seed(4)
        lora = {k: torch.randn(v.shape, generator=g) for k, v in shapes.items() if "_lora." in k}
        value = str(tmp_path / "lora.ckpt")
        torch.save({"lora_state_dict": lora}, value)
    if name == "controlnet_ckpt":   # a SparseCtrl file of the pyramid layout, drawn
        from cvd_tpu_torch.models.sparse_controlnet import SparseControlNetModel
        from cvd_tpu_torch.pipelines.common import random_init_

        sparsectrl = random_init_(SparseControlNetModel(SMOKE_WIDTHS[0]),
                                  torch.Generator().manual_seed(6)).state_dict()
        value = str(tmp_path / "sparsectrl.ckpt")
        torch.save(sparsectrl, value)
    modules = _build(paths, **{name: value})
    unet = modules.unet
    sd = unet.state_dict()
    has_lora = any("_lora." in k for k in sd)
    has_sync = any("_lora_sync." in k for k in sd)
    if name == "image_lora_ckpt":
        assert all(torch.equal(sd[k], v) for k, v in lora.items()) and not has_sync
    elif name == "sync_lora_rank":       # rank channels // 4 (no image LoRA to divide by)
        assert has_sync and not has_lora and unet.config.sync_lora_rank == value
        assert sd["down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0."
                  "attention_blocks.0.processor.to_q_lora_sync.down.weight"].shape == (8, 32)
    elif name == "spatial_extended_attention":
        assert unet.config.spatial_extended_attention and not has_lora
        blk = unet.down_blocks[0].attentions[0].transformer_blocks[0]
        assert blk.extended_attention and not blk.fused
    elif name == "controlnet_ckpt":    # built beside the UNet from the file
        got = modules.controlnet.state_dict()
        assert set(got) == set(sparsectrl)
        assert all(torch.equal(got[k], v) for k, v in sparsectrl.items())
    elif name == "remat_policy":   # reaches the UNetConfig; only a training remat reads it
        assert unet.config.remat_policy == value and not has_lora and not has_sync
    elif name == "controlnet_simplified_embedding":   # the layout, without a file: no model
        assert modules.controlnet is None and not has_lora and not has_sync
    elif name == "civitai_base_model":   # the spatial UNet, the VAE and CLIP from the model
        assert all(torch.equal(sd[k], v) for k, v in values["unet"].items())
        assert all(torch.equal(modules.clip.state_dict()[k], v)
                   for k, v in values["clip"].items())
        assert all(torch.equal(v, plain[k]) for k, v in sd.items() if k not in values["unet"])
    elif name == "civitai_lora_ckpt":   # fused over the SD folder's attention / ff weights
        moved = {k for k, v in sd.items() if not torch.equal(v, plain[k])}
        assert moved and all(k.endswith((".weight")) and k in values["unet"] for k in moved)
        assert moved == {k for k in values["unet"]
                         if k.endswith(("to_q.weight", "to_k.weight", "to_v.weight",
                                        "to_out.0.weight", "proj_in.weight", "proj_out.weight",
                                        "ff.net.0.proj.weight", "ff.net.2.weight"))}
    else:   # the image LoRA's rank without its file, sync scale 0 without a rank: no-ops
        assert not has_lora and not has_sync


@pytest.mark.parametrize("option", REFUSED, ids=lambda o: next(iter(o)))
def test_unported_model_options_raise_before_a_file_is_opened(option, paths, tmp_path, civitai):
    """Every path points nowhere: a FileNotFoundError would mean that
    something was read before the option was refused. An option of PORTED is
    taken instead: a build from the tiny files with it has what it sets."""
    from cvd_tpu_torch.cli.build import build_modules

    name, value = next(iter(option.items()))
    if name in PORTED:
        _check_ported(paths, tmp_path, name, value, civitai)
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, queue 1, item"):
        build_modules(model_args(NOWHERE, **option), torch.device("cpu"))


def _inference_args(paths, out_root, **kw):
    from cvd_tpu_torch.cli import inference

    args = inference.build_parser().parse_args([
        "--device", "cpu", "--image_height", "64", "--image_width", "64", "--video_length", "2",
        "--num_inference_steps", "2",
        "--caption_file", os.path.join(ASSETS, "example_prompts.json"), "--use_negative_prompt",
        "--pose_file_0", os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
        "--pose_file_1", os.path.join(ASSETS, "pose_files", "example_arc.txt"),
        "--out_root", str(out_root)])
    for k, v in {**paths, **kw}.items():
        setattr(args, k, v)
    return args


def _advanced_args(paths, out_root, **kw):
    from cvd_tpu_torch.cli import inference_advanced

    args = inference_advanced.build_parser().parse_args([
        "--device", "cpu", "--view_num", "4", "--video_length", "2", "--image_height", "64",
        "--image_width", "64", "--num_inference_steps", "2", "--multistep", "2",
        "--accumulate_step", "2", "--caption_file", os.path.join(ASSETS, "example_prompts.json"),
        "--use_negative_prompt", "--out_root", str(out_root)])
    for k, v in {**paths, **kw}.items():
        setattr(args, k, v)
    return args


def _train_cfg(paths, out_dir, **kw):
    cfg = dict(output_dir=str(out_dir), device="cpu", bf16=False, sample_size=64,
               sample_n_frames=2, train_batch_size=1, num_workers=1, max_train_steps=2,
               checkpointing_steps=2, logger_interval=1, learning_rate=1e-3, global_seed=3,
               do_sanity_check=False, **paths)
    cfg.update(kw)
    return cfg


class _Pairs:
    """In-memory folded pairs with RealEstate10KPoseFolded's sample keys: the
    cameras of assets/pose_files, seeded pixels."""

    def __init__(self, n_frames=2, size=64):
        from cvd_tpu_torch.data.validation import ValRealEstate10KPoseFolded

        cams = ValRealEstate10KPoseFolded(
            ["a quiet living room"], os.path.join(ASSETS, "pose_files", "example_dolly.txt"),
            os.path.join(ASSETS, "pose_files", "example_arc.txt"),
            sample_n_frames=n_frames, sample_size=size)[0]
        self.plucker = cams["plucker_embedding"].astype(np.float32)
        self.F_mats = cams["F_mats"].astype(np.float32)
        self.shape = (2 * n_frames, size, size, 3)

    def __len__(self):
        return 2

    def __getitem__(self, i):
        rng = np.random.default_rng(int(i))
        return {"pixel_values": rng.uniform(-1, 1, self.shape).astype(np.float32),
                "text": "a quiet living room", "plucker_embedding": self.plucker,
                "F_mats": self.F_mats}


@pytest.mark.parametrize("entry", ["inference", "inference_advanced", "train"])
def test_entry_points_refuse_unported_options_first(entry, paths, civitai, tmp_path):
    """The civitai options, refused until they were ported, are taken by
    every entry point: each runs from the tiny files with a civitai model and
    a kohya LoRA over them."""
    from cvd_tpu_torch.cli import inference, inference_advanced, train

    model, lora, values = civitai
    files = dict(paths, civitai_base_model=model, civitai_lora_ckpt=lora)
    out = tmp_path / "out"
    if entry == "inference":
        (v,) = [r["videos"] for r in inference.main(
            _inference_args(files, out), tokenizer=_tokenizer(), widths=SMOKE_WIDTHS)[:1]]
    elif entry == "inference_advanced":
        (v,) = [r["videos"] for r in inference_advanced.main(
            _advanced_args(files, out), tokenizer=_tokenizer(), widths=SMOKE_WIDTHS)[:1]]
    else:
        run = train.run(_train_cfg(files, out), sources=[_Pairs()], tokenizer=_tokenizer(),
                        widths=SMOKE_WIDTHS)
        assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
        frozen = run["state"].model.state_dict()
        assert torch.equal(frozen["conv_in.weight"],
                           values["unet"]["conv_in.weight"].to(frozen["conv_in.weight"].dtype))
        return
    assert np.isfinite(v).all() and v.std() > 0 and out.exists()


def test_no_weights_source_raises_naming_both():
    from cvd_tpu_torch.cli.build import build_modules

    with pytest.raises(ValueError) as e:
        build_modules(model_args({}), torch.device("cpu"))
    assert "--ori_model_path" in str(e.value) and "--random-weights" in str(e.value)
    assert "random_weights_full" in str(e.value)      # and the training config's keys


@pytest.mark.parametrize("mode", ["random_weights", "random_weights_full"])
@pytest.mark.parametrize("option", ["ori_model_path", "motion_module_ckpt", "motion_lora_ckpt",
                                    "epi_module_ckpt", "pose_adaptor_ckpt"])
def test_random_weights_refuse_a_weight_option(mode, option):
    """It would be ignored: the random-weights branch reads no file."""
    from cvd_tpu_torch.cli.build import build_modules

    args = model_args({option: "/nonexistent/file"}, **{mode: True})
    with pytest.raises(ValueError, match=f"--{option}"):
        build_modules(args, torch.device("cpu"))


@pytest.mark.parametrize("edit", [False, True], ids=["released", "edited"])
def test_random_weights_take_a_model_config(edit, tmp_path):
    """A model config is a layout, not weights: random weights are drawn at
    the smoke widths with the modules and scheduler it sets."""
    import yaml

    from cvd_tpu_torch.cli.build import build_modules

    path = MODEL_CONFIG
    if edit:
        raw = yaml.safe_load(open(MODEL_CONFIG))
        raw["unet_additional_kwargs"]["motion_module_resolutions"] = [1, 2]
        raw["noise_scheduler_kwargs"]["beta_schedule"] = "scaled_linear"
        path = str(tmp_path / "edited.yaml")
        open(path, "w").write(yaml.safe_dump(raw))
    m, _ = build_modules(model_args({"model_config": path}, random_weights=True),
                         torch.device("cpu"))
    cfg = m.unet.config
    assert cfg.block_out_channels == SMOKE_WIDTHS[0].block_out_channels and m.clip_2 is None
    assert cfg.motion_module_resolutions == ((1, 2) if edit else (1, 2, 4, 8))
    assert m.scheduler.beta_schedule == ("scaled_linear" if edit else "linear")
    assert [b.motion_modules is not None for b in m.unet.down_blocks] == (
        [True, True, False, False] if edit else [True] * 4)


def test_a_pickle_that_weights_only_refuses_is_read_with_a_warning(tmp_path):
    import argparse

    from cvd_tpu_torch.io.torch_io import load_torch_state

    path = str(tmp_path / "legacy.ckpt")
    torch.save({"args": argparse.Namespace(lr=1e-4), "w": torch.ones(2)}, path)
    with pytest.warns(UserWarning, match="weights_only=False"):
        state = load_torch_state(path)
    assert list(state) == ["w"] and torch.equal(state["w"], torch.ones(2))
    torch.save({"w": torch.ones(2), "epoch": 3}, path)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert list(load_torch_state(path)) == ["w"]


def test_motion_lora_needs_the_motion_module(paths):
    from cvd_tpu_torch.cli.build import build_modules

    with pytest.raises(ValueError, match="--motion_module_ckpt"):
        build_modules(model_args(paths, motion_module_ckpt=None, motion_lora_ckpt="/nonexistent"),
                      torch.device("cpu"), tokenizer=_tokenizer())


def test_real_weights_get_the_real_tokenizer_or_an_error(paths, tmp_path):
    """Never the hash stand-in: a folder without ``tokenizer/`` is refused,
    before any weight is read."""
    from cvd_tpu_torch.cli.build import build_modules
    from cvd_tpu_torch.io.tokenizer import HashTokenizer, get_tokenizer

    with pytest.raises(FileNotFoundError, match="tokenizer"):
        get_tokenizer(str(tmp_path))
    assert isinstance(get_tokenizer(None), HashTokenizer)
    with pytest.raises(FileNotFoundError, match="no CLIP tokenizer"):
        build_modules(model_args(paths), torch.device("cpu"))
    with pytest.raises(FileNotFoundError, match="no CLIP tokenizer"):
        build_modules(model_args(dict(NOWHERE, ori_model_path=str(tmp_path))),
                      torch.device("cpu"))
    given = object()
    assert build_modules(model_args(paths), torch.device("cpu"), tokenizer=given,
                         widths=SMOKE_WIDTHS)[1] is given
    assert build_modules(model_args({}, random_weights=True), torch.device("cpu"),
                         tokenizer=given)[1] is given


def test_clip_tokenizer_wrapper_on_a_local_vocabulary(tmp_path):
    """``CLIPTokenizerWrapper`` on a six-token vocabulary written here (the
    real one is not in the repository): ids [B, 77] int32, BOS first, padded."""
    pytest.importorskip("transformers")
    from cvd_tpu_torch.io.tokenizer import CLIPTokenizerWrapper, get_tokenizer

    tok_dir = tmp_path / "tokenizer"
    tok_dir.mkdir()
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2, "b</w>": 3, "a": 4, "b": 5}
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (tok_dir / "merges.txt").write_text("#version: 0.2\n")
    (tok_dir / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 77}))
    tok = get_tokenizer(str(tmp_path))
    assert isinstance(tok, CLIPTokenizerWrapper) and tok.model_max_length == 77
    ids = tok(["a b", "b"])
    assert ids.shape == (2, 77) and ids.dtype == np.int32
    assert ids[0, :4].tolist() == [0, 2, 3, 1] and ids[1, :3].tolist() == [0, 3, 1]


# ------------------------------------------------- entry points from the files

def test_inference_cli_from_checkpoint_files(paths, tmp_path):
    from cvd_tpu_torch.cli import inference

    records = inference.main(_inference_args(paths, tmp_path, model_config=MODEL_CONFIG),
                             tokenizer=_tokenizer(), widths=SMOKE_WIDTHS)
    assert len(records) == 2
    for idx, rec in enumerate(records):
        v = rec["videos"]
        assert v.shape == (2, 2, 64, 64, 3) and np.isfinite(v).all() and v.std() > 0
        assert np.load(tmp_path / str(idx) / "videos.npy").shape == (2, 2, 64, 64, 3)


def test_inference_advanced_cli_from_checkpoint_files(paths, tmp_path):
    from cvd_tpu_torch.cli import inference_advanced

    records = inference_advanced.main(_advanced_args(paths, tmp_path), tokenizer=_tokenizer(),
                                      widths=SMOKE_WIDTHS)
    assert len(records) == 2
    v = records[0]["videos"]
    assert v.shape == (4, 2, 64, 64, 3) and np.isfinite(v).all() and v.std() > 0


def test_train_run_from_checkpoint_files(paths, tmp_path):
    from cvd_tpu_torch.cli import train
    from cvd_tpu_torch.io.torch_io import load_torch_state

    out = train.run(_train_cfg(paths, tmp_path / "run", model_config=MODEL_CONFIG),
                    sources=[_Pairs()], tokenizer=_tokenizer(), widths=SMOKE_WIDTHS)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    # it went on from the epi checkpoint: the saved trainable set holds its keys, moved
    epi = load_torch_state(paths["epi_module_ckpt"], "unet_trainable_dict")
    saved = torch.load(tmp_path / "run" / "checkpoints" / "checkpoint-step-2.ckpt",
                       weights_only=True)["unet_trainable_dict"]
    assert set(saved) == set(epi)
    assert all(not torch.equal(saved[k], epi[k]) for k in epi)
    frozen = out["state"].model.state_dict()
    mm = load_torch_state(paths["motion_module_ckpt"])
    key = next(k for k in mm if k.endswith("to_q.weight"))
    assert torch.equal(frozen[key], mm[key].to(torch.bfloat16))


def test_refuse_unported_keeps_three_checkpoint_keys(tmp_path):
    """The config keys of the three checkpoint options beside the entry
    points' (the two civitai ones are taken since they were ported)."""
    from cvd_tpu_torch.cli import train

    assert train._CHECKPOINT_KEYS == ("image_lora_ckpt", "civitai_lora_ckpt",
                                      "civitai_base_model")
    train._refuse_unported(_train_cfg(NOWHERE, tmp_path, model_config=MODEL_CONFIG))


# ------------------------------------------------------------ --validate-ckpts

def test_validate_ckpts_on_the_manifests(capsys):
    from cvd_tpu_torch.cli import build

    with pytest.raises(SystemExit) as e:
        build.main(["--validate-ckpts"])
    assert e.value.code == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[validate-ckpts]")]
    assert len(lines) == 8 and all(ln.endswith("-> ok") for ln in lines[:7])
    assert "686 keys" in lines[0] and "560 keys" in lines[3] and "520 keys" in lines[4]
    assert lines[-1].endswith("all artifacts map cleanly")
    with pytest.raises(SystemExit) as e:
        build.main([])
    assert e.value.code == 2


def test_validate_ckpts_on_files_and_a_renamed_key(paths, tmp_path, capsys):
    from cvd_tpu_torch.cli import build

    args = model_args(paths)
    assert build.validate_ckpts(args, widths=SMOKE_WIDTHS) == 0
    capsys.readouterr()
    epi = torch.load(paths["epi_module_ckpt"], weights_only=True)
    state = epi["unet_trainable_dict"]
    key = next(k for k in state if k.endswith("proj_in.weight"))
    state[key.replace("proj_in", "proj_inn")] = state.pop(key)
    torch.save(epi, tmp_path / "epi_renamed.ckpt")
    args.epi_module_ckpt = str(tmp_path / "epi_renamed.ckpt")
    assert build.validate_ckpts(args, widths=SMOKE_WIDTHS) == 1
    out = capsys.readouterr().out
    assert "proj_inn" in out and out.splitlines()[-1].endswith("FAILED")
    assert sum(ln.endswith("-> ok") for ln in out.splitlines()) == 6
    # against the full-size modules the narrow files do not fit
    assert build.validate_ckpts(model_args(paths)) == 1


# ----------------------------------------- what a load must leave right

def test_epi_checkpoint_reaches_the_f32_masters_unrounded(paths, tmp_path):
    """Training holds the UNet in f32 until ``create_train_state`` casts its
    frozen part, so an epi file's values that bf16 cannot hold are bit-equal
    in the masters, whatever ``bf16`` says."""
    from cvd_tpu_torch.cli import train
    from cvd_tpu_torch.train.state import create_train_state

    epi = torch.load(paths["epi_module_ckpt"], weights_only=True)
    state = epi["unet_trainable_dict"]
    for k in state:
        state[k] = state[k] + 2.0 ** -20     # off every bf16 value
    assert all(not torch.equal(v, v.to(torch.bfloat16).float()) for v in state.values())
    torch.save(epi, tmp_path / "epi_f32.ckpt")
    cfg = _train_cfg(dict(paths, epi_module_ckpt=str(tmp_path / "epi_f32.ckpt")), tmp_path,
                     bf16=True)
    modules, _ = train.build_training_modules(cfg, torch.device("cpu"), _tokenizer(),
                                              SMOKE_WIDTHS)
    ts = create_train_state(modules.unet, frozen_dtype=torch.bfloat16)
    params = dict(ts.model.named_parameters())
    assert sorted(ts.trainable) == sorted(state)
    for k, v in state.items():
        assert params[k].dtype == torch.float32 and torch.equal(params[k], v), k
    frozen = [p for n, p in params.items() if n not in state]
    assert frozen and all(p.dtype == torch.bfloat16 for p in frozen)
    assert hasattr(modules.vae, "encoder")
    assert next(modules.vae.parameters()).dtype == torch.bfloat16


def test_fold_cache_sees_a_loads_in_place_copies():
    """K5's fold cache (keyed by identity, storage and ``_version``) must
    not hand a loaded model the folded weights of the one before: forward,
    load other weights, forward again, and compare with a fresh module."""
    from cvd_tpu_torch.io.checkpoints import merge_torch_state
    from cvd_tpu_torch.models.layers import BasicTransformerBlock
    from cvd_tpu_torch.ops.ln_matmul import fold_weights, folded

    def fold_of(block):
        a = block.attn1
        return folded(block.norm1.weight, block.norm1.bias,
                      [a.to_q.weight, a.to_k.weight, a.to_v.weight], [None] * 3, torch.float32)

    torch.manual_seed(0)
    block = BasicTransformerBlock(32, 4, 8, cross_attention_dim=24).requires_grad_(False)
    other = BasicTransformerBlock(32, 4, 8, cross_attention_dim=24).requires_grad_(False)
    x, ctx = torch.randn(2, 16, 32), torch.randn(2, 7, 24)
    first = block(x, ctx)
    w1 = fold_of(block)
    assert fold_of(block)[0] is w1[0]                       # cached
    for load in (lambda: merge_torch_state(block, other.state_dict()),
                 lambda: block.load_state_dict(other.state_dict())):
        other.attn1.to_q.weight.mul_(1.5)
        other.norm1.bias.add_(0.1)
        load()
        w2 = fold_of(block)
        a = other.attn1
        want = fold_weights(other.norm1.weight, other.norm1.bias,
                            [a.to_q.weight, a.to_k.weight, a.to_v.weight], [None] * 3,
                            torch.float32)
        assert w2[0] is not w1[0]
        assert torch.equal(w2[0], want[0]) and torch.equal(w2[1], want[1])
        assert torch.equal(block(x, ctx), other(x, ctx))
        w1 = w2
    assert not torch.equal(first, block(x, ctx))

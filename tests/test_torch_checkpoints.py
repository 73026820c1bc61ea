"""Checkpoint import of cvd_tpu_torch against cvd_tpu's, on the CPU.

* Coverage at full size: the port's SD1.5-width modules on the ``meta``
  device hold every key of every manifest (after the VAE and CLIP renames)
  with the same shape, or the key is a named skipped buffer; the UNet's four
  artifacts together leave none of its parameters uncovered.
* The same files through both packages: tiny checkpoint files in the
  released layouts (``write_tiny_checkpoints``) are loaded by
  ``cvd_tpu.io.checkpoints.load_sd_pipeline_weights`` and by the port's;
  module outputs agree to 1e-4 x max|ref| in f32 (one forward each, so only
  summation order differs) and the 2-view sampler's final latents at
  >= 60 dB, the bar of tests/test_torch_slice.py.
* Each loader's contract, LoRA fusion against ``cvd_tpu.io.lora`` (1e-6),
  ``merge_lora``, the model config and the scheduler's fields.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-4
Fr, S = 2, 8  # frames, latent size


# ------------------------------------------------------- tiny checkpoint files

_VAE_TO_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _vae_legacy_key(key):
    """Modern diffusers VAE attention name -> the SD-era one the released
    file has (the inverse of ``vae_legacy_rename``)."""
    if ".attentions." not in key:
        return key
    for new, old in _VAE_TO_LEGACY.items():
        key = key.replace(f".{new}.", f".{old}.")
    return key


def _clip_hf_key(key):
    """``CLIPTextEncoder`` key -> transformers' (the inverse of ``clip_rename``)."""
    if key == "position_embedding":
        return "text_model.embeddings.position_embedding.weight"
    if key.startswith("token_embedding"):
        return "text_model.embeddings." + key
    if key.startswith("layers."):
        return "text_model.encoder." + key
    return "text_model." + key


def _with_pe_buffers(state, length):
    """Add the ``pos_encoder.pe`` buffer the released files carry beside
    every temporal attention's ``to_q``."""
    out = dict(state)
    for key, value in state.items():
        if "attention_blocks" in key and key.endswith(".to_q.weight"):
            out[key[: -len("to_q.weight")] + "pos_encoder.pe"] = np.zeros(
                (1, length, value.shape[0]), np.float32)
    return out


def _tensors(state):
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in state.items()}


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.standard_normal(a.shape) * 0.02, jnp.float32),
        tree)


def write_tiny_checkpoints(root, unet_params, vae_params, clip_params, pose_params):
    """Write Flax param trees as the four released artifact kinds, in the
    files' own layouts -> the paths, as the CLI options name them. Keys come
    from ``export_torch_state`` with what it gets wrong for a checkpoint put
    right (``time_embedding.linear_{1,2}``); the VAE gets its legacy
    attention names and goes to ``.safetensors``, CLIP its transformers names,
    ``position_ids`` and a ``text_projection``; the motion module and the
    pose encoder get ``pos_encoder.pe`` buffers; the epi file nests its dict
    beside ``epoch`` / ``global_step`` and the pose file its two."""
    from safetensors.torch import save_file

    from cvd_tpu.io.key_mapping import export_torch_state

    root = str(root)
    unet = {k.replace("time_embedding.linear.", "time_embedding.linear_"): v
            for k, v in export_torch_state(unet_params).items()}
    merge = {k: v for k, v in unet.items() if ".processor.qkv_merge." in k}
    motion = {k: v for k, v in unet.items() if "motion_modules" in k and k not in merge}
    epi = {k: v for k, v in unet.items() if "epi_modules" in k}
    base = {k: v for k, v in unet.items() if k not in merge and k not in motion and k not in epi}
    assert merge and motion and epi and "time_embedding.linear_1.weight" in base

    for sub in ("unet", "vae", "text_encoder"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    torch.save(_tensors(base), os.path.join(root, "unet", "diffusion_pytorch_model.bin"))
    vae = {_vae_legacy_key(k): v for k, v in export_torch_state(vae_params).items()}
    assert any(k.endswith(".query.weight") for k in vae)
    save_file(_tensors(vae), os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"))
    clip = {_clip_hf_key(k): v for k, v in export_torch_state(clip_params).items()}
    clip["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    clip["text_projection.weight"] = np.zeros((4, 4), np.float32)
    torch.save(_tensors(clip), os.path.join(root, "text_encoder", "pytorch_model.bin"))

    paths = dict(ori_model_path=root, unet_subfolder="unet",
                 motion_module_ckpt=os.path.join(root, "mm.ckpt"),
                 epi_module_ckpt=os.path.join(root, "epi.ckpt"),
                 pose_adaptor_ckpt=os.path.join(root, "pose.ckpt"))
    torch.save(_tensors(_with_pe_buffers(motion, 32)), paths["motion_module_ckpt"])
    torch.save({"epoch": 3, "global_step": 1234, "unet_trainable_dict": _tensors(epi)},
               paths["epi_module_ckpt"])
    pose = _with_pe_buffers(export_torch_state(pose_params), 16)
    torch.save({"pose_encoder_state_dict": _tensors(pose),
                "attention_processor_state_dict": _tensors(merge)}, paths["pose_adaptor_ckpt"])
    return paths


def model_args(paths, **kw):
    """The model options of the CLIs for ``paths``."""
    from cvd_tpu_torch.cli.build import add_model_args

    p = argparse.ArgumentParser()
    add_model_args(p)
    args = p.parse_args(["--device", "cpu"])
    for k, v in {**paths, **kw}.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """(paths, the JAX bundle that cvd_tpu's loader filled from them)."""
    from tiny import tiny_modules

    from cvd_tpu.io.checkpoints import load_sd_pipeline_weights

    base = tiny_modules(latent_size=S, video_length=Fr)
    paths = write_tiny_checkpoints(
        tmp_path_factory.mktemp("ckpt"), perturbed(base.unet_params, 0),
        perturbed(base.vae_params, 1), perturbed(base.clip_params, 2),
        perturbed(base.pose_encoder_params, 3))
    unet, vae, clip, pose = load_sd_pipeline_weights(
        base.unet_params, base.vae_params, base.clip_params, paths["ori_model_path"],
        motion_module_ckpt=paths["motion_module_ckpt"],
        epi_module_ckpt=paths["epi_module_ckpt"],
        pose_adaptor_ckpt=paths["pose_adaptor_ckpt"],
        pose_encoder_params=base.pose_encoder_params)
    return paths, dataclasses.replace(base, unet_params=unet, vae_params=vae,
                                      clip_params=clip, pose_encoder_params=pose)


@pytest.fixture(scope="module")
def port_modules(tiny_files):
    """The port's bundle built from the same files by ``build_modules``."""
    from cvd_tpu_torch.cli import build
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    paths, _ = tiny_files
    return build.build_modules(model_args(paths), torch.device("cpu"),
                               tokenizer=HashTokenizer(), widths=build.SMOKE_WIDTHS)[0]


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max(), err_msg=what)


# ------------------------------------------- coverage at full size (meta device)

@pytest.fixture(scope="module")
def full_size():
    from cvd_tpu_torch.pipelines.common import PipelineModules

    return PipelineModules.create(device="meta", vae_encoder=True)


@pytest.fixture(scope="module")
def sdxl_full_size():
    """The SDXL-backbone bundle of ``configs/sdxl_inference_config.yaml`` on
    ``meta``."""
    from cvd_tpu_torch.cli.build import SD15_WIDTHS, _model_config
    from cvd_tpu_torch.pipelines.common import PipelineModules

    unet, vae, clip, clip_2, pose, _ = _model_config(
        os.path.join(REPO, "configs", "sdxl_inference_config.yaml"), *SD15_WIDTHS)
    return PipelineModules.create(unet, vae, clip, device="meta", pose_encoder_kwargs=pose,
                                  clip_2_config=clip_2)


def _manifest_cases():
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import clip_rename, vae_legacy_rename

    return {
        "sd15_unet": ("unet", M.sd15_unet_manifest(), None, 686),
        "motion_module": ("unet", M.animatediff_v3_mm_manifest(), None, 560),
        "epi_module": ("unet", M.cvd_epi_ckpt_manifest(), None, 520),
        "attention_processor": ("unet", M.cameractrl_attention_processor_manifest(), None, 40),
        "sd15_vae": ("vae", M.sd15_vae_manifest(), vae_legacy_rename, 248),
        "sd15_clip": ("clip", M.sd15_clip_manifest(), clip_rename, 197),
        "pose_encoder": ("pose_encoder", M.cameractrl_pose_encoder_manifest(), None, 150),
        "sdxl_unet": ("unet", M.sdxl_unet_manifest(), None, 1680),
        "sdxl_clip_2": ("clip_2", M.sdxl_clip_2_manifest(), clip_rename, 518),
    }


# the LoRA artifacts, against a UNet built with the options that make their
# parameters: (manifest, UNetConfig fields, keys)
_LORA_CASES = {
    "sync_lora_4": ("cvd_sync_lora_manifest", (4, 4), dict(sync_lora_rank=4), 160),
    "sync_lora_32": ("cvd_sync_lora_manifest", (32, 4), dict(sync_lora_rank=32), 160),
    "image_lora_2": ("cameractrl_image_lora_manifest", (2,), dict(spatial_lora_rank=-2), 256),
}


@pytest.mark.parametrize("artifact", ["sd15_unet", "motion_module", "epi_module",
                                      "attention_processor", "sd15_vae", "sd15_clip",
                                      "pose_encoder", *_LORA_CASES, "sparsectrl",
                                      "sparsectrl_simplified", "sdxl_unet", "sdxl_clip_2"])
def test_manifest_keys_are_the_ports_state_dict_keys(artifact, full_size, request):
    """Every key of the manifest, after its rename, is a key of the port's
    full-size ``state_dict()`` with the same shape, or a named skipped
    buffer: held key by key, not through the importer. The sync-LoRA (ranks
    4 and 32) and the image LoRA (``--image_lora_rank 2``) against a
    ``meta`` UNet built with them, which has no other LoRA key; SparseCtrl
    (both layouts) against a ``meta`` ``SparseControlNetModel`` of the same
    layout, which the file fills whole. The SDXL UNet and ``text_encoder_2``
    against the bundle of ``configs/sdxl_inference_config.yaml``."""
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import SKIP_SUBSTRINGS
    from cvd_tpu_torch.models.sparse_controlnet import SparseControlNetModel
    from cvd_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

    if artifact.startswith("sparsectrl"):
        simplified = artifact.endswith("simplified")
        manifest = M.animatediff_sparsectrl_manifest(simplified)
        with torch.device("meta"):
            sd = SparseControlNetModel(conditioning_channels=4 if simplified else 3,
                                       use_simplified_condition_embedding=simplified).state_dict()
        assert len(manifest) == (486 if simplified else 500)
        params = {k: s for k, s in manifest.items() if "pos_encoder" not in k}
        assert len(manifest) - len(params) == 8   # one PE buffer a motion module
        assert set(sd) == set(params)
        for key, shape in params.items():
            assert tuple(sd[key].shape) == tuple(shape), key
        return

    if artifact in _LORA_CASES:
        fn, args, options, n_keys = _LORA_CASES[artifact]
        manifest = getattr(M, fn)(*args)
        with torch.device("meta"):
            sd = UNet3DConditionModel(UNetConfig(**options)).state_dict()
        assert len(manifest) == n_keys
        assert {k for k in sd if "_lora" in k} == set(manifest)
        for key, shape in manifest.items():
            assert tuple(sd[key].shape) == tuple(shape), key
        return
    name, manifest, rename, n_keys = _manifest_cases()[artifact]
    assert len(manifest) == n_keys
    if artifact.startswith("sdxl"):
        full_size = request.getfixturevalue("sdxl_full_size")
    sd = getattr(full_size, name).state_dict()
    skipped = 0
    for key, shape in manifest.items():
        key = rename(key) if rename else key
        if any(s in key for s in SKIP_SUBSTRINGS):
            skipped += 1
            continue
        assert key in sd, f"{artifact}: the port has no {key}"
        assert tuple(sd[key].shape) == tuple(shape), key
    want_skipped = {"motion_module": 40, "sd15_clip": 1, "pose_encoder": 8,
                    "sdxl_clip_2": 1}.get(artifact, 0)
    assert skipped == want_skipped
    if name != "unet":   # one artifact fills the whole module
        assert len(sd) == len(manifest) - skipped


def test_time_embedding_keys_are_the_checkpoints(full_size):
    sd = full_size.unet.state_dict()
    for key in ("time_embedding.linear_1.weight", "time_embedding.linear_1.bias",
                "time_embedding.linear_2.weight", "time_embedding.linear_2.bias"):
        assert key in sd
    assert not [k for k in sd if k.startswith("time_embedding.linear.")]


def test_unet_artifacts_cover_every_parameter(full_size):
    """The SD folder, the motion module, the epi checkpoint and the pose
    adaptor's processors are disjoint and together fill every UNet
    parameter: nothing is left that no checkpoint can give."""
    from cvd_tpu_torch.io.checkpoints import SKIP_SUBSTRINGS

    cases = _manifest_cases()
    seen = []
    for artifact in ("sd15_unet", "motion_module", "epi_module", "attention_processor"):
        seen += [k for k in cases[artifact][1] if not any(s in k for s in SKIP_SUBSTRINGS)]
    assert len(seen) == len(set(seen)) == 686 + 520 + 520 + 40
    assert set(seen) == set(full_size.unet.state_dict())
    assert not list(full_size.unet.buffers())


@pytest.mark.parametrize("name", [
    "sd15_unet_manifest", "sd15_vae_manifest", "sd15_clip_manifest",
    "animatediff_v3_mm_manifest", "cvd_epi_ckpt_manifest", "cvd_sync_lora_manifest",
    "animatediff_sparsectrl_manifest", "cameractrl_pose_encoder_manifest",
    "cameractrl_attention_processor_manifest", "ldm_sd15_unet_manifest",
    "ldm_sd15_vae_manifest", "ldm_sd15_clip_manifest"])
def test_manifests_are_cvd_tpus(name):
    """The port's copy of the manifests has not drifted from cvd_tpu's."""
    from cvd_tpu.io import manifests as JM
    from cvd_tpu_torch.io import manifests as PM

    assert getattr(PM, name)() == getattr(JM, name)()
    # the port adds the image LoRA's and the SDXL backbone's, which cvd_tpu has none of
    assert [n for n in dir(JM) if n.endswith("_manifest") and not n.startswith("_")] == \
        [n for n in dir(PM) if n.endswith("_manifest") and not n.startswith("_")
         and n not in ("cameractrl_image_lora_manifest", "sdxl_clip_2_manifest",
                       "sdxl_unet_manifest")]


def test_random_state_has_the_manifests_layout():
    from cvd_tpu_torch.io import manifests as M

    manifest = {**M.cameractrl_pose_encoder_manifest(),
                "text_model.embeddings.position_ids": (1, 77)}
    a = M.random_state(manifest, torch.Generator().manual_seed(5), torch.float16)
    b = M.random_state(manifest, torch.Generator().manual_seed(5), torch.float16)
    assert list(a) == list(manifest)
    for key, shape in manifest.items():
        assert tuple(a[key].shape) == tuple(shape) and torch.equal(a[key], b[key]), key
    assert torch.equal(a["text_model.embeddings.position_ids"], torch.arange(77)[None])
    w = a["encoder_down_conv_blocks.1.0.block1.weight"].float()
    assert abs(float(w.var()) * w[0].numel() - 1.0) < 0.05      # variance 1 / fan_in
    scale = a["encoder_down_attention_blocks.0.0.norms.0.weight"].float()
    assert float((scale - 1).abs().max()) <= 0.1 + 1e-3
    pe = a["encoder_down_attention_blocks.0.0.attention_blocks.0.pos_encoder.pe"]
    assert pe.shape == (1, 16, 320) and float(pe[0, 0, 1]) == 1.0 and float(pe[0, 0, 0]) == 0.0


# ------------------------------------------- the same files through both packages

def test_every_parameter_comes_from_the_files(tiny_files, port_modules):
    """No parameter of the port's bundle is left at its initial value, and
    each equals cvd_tpu's after its load of the same files."""
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax

    _, jm = tiny_files
    for name, tree in (("unet", jm.unet_params), ("clip", jm.clip_params),
                       ("pose_encoder", jm.pose_encoder_params), ("vae", jm.vae_params)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        got = getattr(port_modules, name).state_dict()
        assert set(got) <= set(want) and (name == "vae" or set(got) == set(want))
        for key, value in got.items():
            assert torch.equal(value, want[key]), f"{name}.{key}"


def test_unet_from_files_matches_jax(tiny_files, port_modules):
    from cvd_tpu.models.pose_adaptor import PoseAdaptor as JaxPoseAdaptor
    from cvd_tpu_torch.models.pose_adaptor import PoseAdaptor

    _, jm = tiny_files
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, jm.unet.config.cross_attention_dim)).astype(np.float32)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    t = np.array([901, 401], dtype=np.int32)
    want, _ = JaxPoseAdaptor(jm, F_mat_size=256, rand_slope_ff=False)(
        jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(plucker),
        jnp.asarray(F_mats))
    with torch.no_grad():
        got = PoseAdaptor(port_modules, F_mat_size=256, rand_slope_ff=False)(
            torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
            torch.from_numpy(plucker), torch.from_numpy(F_mats))
    close(got, want, "unet + pose encoder")


def test_vae_clip_and_pose_encoder_from_files_match_jax(tiny_files, port_modules):
    _, jm = tiny_files
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    ids = rng.integers(0, 49408, (2, 77)).astype(np.int32)
    plucker = rng.standard_normal((1, Fr, 64, 64, 6)).astype(np.float32)
    with torch.no_grad():
        close(port_modules.vae.decode(torch.from_numpy(z)),
              jm.vae.apply(jm.vae_params, jnp.asarray(z), method=jm.vae.decode), "vae decode")
        close(port_modules.clip(torch.from_numpy(ids)),
              jm.clip.apply(jm.clip_params, jnp.asarray(ids)), "clip")
        got = port_modules.pose_encoder(torch.from_numpy(plucker))
    want = jm.pose_encoder.apply(jm.pose_encoder_params, jnp.asarray(plucker))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, f"pose feature {i}")


def test_simple_pipeline_from_files_matches_jax(tiny_files, port_modules):
    from cvd_tpu.pipelines.simple import SimplePipeline as JaxPipeline
    from cvd_tpu_torch.io.tokenizer import HashTokenizer   # the same ids in every process
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    _, jm = tiny_files
    rng = np.random.default_rng(2)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    lat0 = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    tok = HashTokenizer()
    ids, neg = tok(["a parity scene"]), tok(["blurry"])
    want = np.asarray(JaxPipeline(jm, F_mat_size=256, rand_slope_ff=False,
                                  use_flash_kernel=False)(
        jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(plucker), jnp.asarray(F_mats),
        num_inference_steps=2, guidance_scale=8.5, rng=jax.random.key(0),
        latents=jnp.asarray(lat0), decode=False))
    got = SimplePipeline(port_modules, F_mat_size=256, rand_slope_ff=False)(
        torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(plucker),
        torch.from_numpy(F_mats), num_inference_steps=2, guidance_scale=8.5,
        latents=torch.from_numpy(lat0), decode=False).numpy()
    snr_db = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    assert snr_db >= 60.0, f"latent SNR {snr_db:.1f} dB < 60 dB"


# ------------------------------------------------------- the loaders' contract

def _linear_pair():
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))


def test_merge_copies_in_place_and_reports_what_it_consumed():
    from cvd_tpu_torch.io.checkpoints import merge_torch_state

    m = _linear_pair().to(torch.bfloat16)
    before = {n: (p.data_ptr(), p._version) for n, p in m.named_parameters()}
    untouched = m[1].weight.clone()
    w = torch.randn(3, 4, dtype=torch.float16)
    consumed = merge_torch_state(m, {"0.weight": w, "0.pos_encoder.pe": torch.zeros(1, 2, 3),
                                     "x.position_ids": torch.arange(3)})
    assert consumed == ["0.weight", "0.pos_encoder.pe", "x.position_ids"]
    assert torch.equal(m[0].weight, w.to(torch.bfloat16)) and m[0].weight.dtype == torch.bfloat16
    assert torch.equal(m[1].weight, untouched)
    # the same storage, written in place: what a cache keyed on it must see
    assert m[0].weight.data_ptr() == before["0.weight"][0]
    assert m[0].weight._version > before["0.weight"][1]
    assert m[1].weight._version == before["1.weight"][1]


def test_unknown_key_and_wrong_shape_raise_and_name_the_key():
    from cvd_tpu_torch.io.checkpoints import merge_torch_state

    m = _linear_pair()
    with pytest.raises(KeyError, match="down_blocks.9.bogus.weight"):
        merge_torch_state(m, {"down_blocks.9.bogus.weight": torch.zeros(3, 3)})
    with pytest.raises(KeyError, match=r"0.weight: shape \(4, 3\)"):
        merge_torch_state(m, {"0.weight": torch.zeros(4, 3)})
    many = {f"nope.{i}.weight": torch.zeros(1) for i in range(12)}
    with pytest.raises(KeyError) as e:
        merge_torch_state(m, many)
    assert "12 checkpoint keys" in e.value.args[0] and "nope.9." in e.value.args[0]
    assert "nope.10." not in e.value.args[0]       # the first ten


def test_legacy_1x1_conv_lands_on_a_linear():
    """LDM-era VAE attention stores q/k/v/proj_out as [o, i, 1, 1] convs."""
    from cvd_tpu_torch.io.checkpoints import merge_torch_state

    m = _linear_pair()
    w = torch.randn(3, 4, 1, 1)
    merge_torch_state(m, {"0.weight": w})
    assert torch.equal(m[0].weight, w[:, :, 0, 0])
    with pytest.raises(KeyError):
        merge_torch_state(m, {"0.weight": torch.randn(3, 4, 3, 3)})


def test_meta_modules_check_routing_without_weights():
    from cvd_tpu_torch.io.checkpoints import merge_torch_state

    with torch.device("meta"):
        m = _linear_pair()
    state = {"0.weight": torch.empty(3, 4, device="meta"), "1.bias": torch.zeros(2)}
    assert merge_torch_state(m, state) == list(state)
    with pytest.raises(KeyError):
        merge_torch_state(m, {"1.bias": torch.zeros(3)})


def test_renames():
    from cvd_tpu.io.checkpoints import clip_rename as jax_clip_rename
    from cvd_tpu.io.key_mapping import vae_legacy_rename as jax_vae_rename
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import clip_rename, vae_legacy_rename

    keys = list(M.sd15_clip_manifest()) + list(M.sd15_vae_manifest()) + [
        "decoder.mid_block.attentions.0.query.weight", "encoder.mid_block.attentions.0.key.bias",
        "decoder.mid_block.attentions.0.proj_attn.weight", "decoder.mid.attn_1.norm.weight",
        "encoder.mid_block.attentions.0.value.bias", "decoder.mid.attn_1.q.weight"]
    for k in keys:
        assert clip_rename(k) == jax_clip_rename(k) and vae_legacy_rename(k) == jax_vae_rename(k)
    assert vae_legacy_rename(keys[-6]) == "decoder.mid_block.attentions.0.to_q.weight"
    assert vae_legacy_rename(keys[-4]) == "decoder.mid_block.attentions.0.to_out.0.weight"


def test_load_torch_state_reads_both_formats_in_the_files_dtype(tmp_path):
    from safetensors.torch import save_file

    from cvd_tpu_torch.io.torch_io import load_diffusers_folder_weights, load_torch_state

    state = {"a.weight": torch.randn(3, 2).half(), "b.position_ids": torch.arange(4)[None]}
    torch.save(state, tmp_path / "plain.ckpt")
    torch.save({"state_dict": state, "epoch": 2}, tmp_path / "wrapped.ckpt")
    torch.save({"epoch": 1, "global_step": 7, "unet_trainable_dict": state},
               tmp_path / "nested.ckpt")
    torch.save(state, tmp_path / "legacy.ckpt", _use_new_zipfile_serialization=False)
    save_file(state, str(tmp_path / "model.safetensors"))
    got = [load_torch_state(str(tmp_path / "plain.ckpt")),
           load_torch_state(str(tmp_path / "wrapped.ckpt")),
           load_torch_state(str(tmp_path / "nested.ckpt"), sub_dict="unet_trainable_dict"),
           load_torch_state(str(tmp_path / "legacy.ckpt")),
           load_torch_state(str(tmp_path / "model.safetensors")),
           load_diffusers_folder_weights(str(tmp_path))]
    for g in got:
        assert set(g) == set(state)
        assert g["a.weight"].dtype == torch.float16 and torch.equal(g["a.weight"], state["a.weight"])
        assert torch.equal(g["b.position_ids"], state["b.position_ids"])
    # without a sub_dict the nested file's ints and dicts are no tensors
    assert load_torch_state(str(tmp_path / "nested.ckpt")) == {}


def test_diffusers_folder_order_and_missing_folder(tmp_path):
    from safetensors.torch import save_file

    from cvd_tpu_torch.io.checkpoints import load_sd_unet_weights
    from cvd_tpu_torch.io.torch_io import load_diffusers_folder_weights

    with pytest.raises(FileNotFoundError, match="no weight file"):
        load_diffusers_folder_weights(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        load_sd_unet_weights(_linear_pair(), str(tmp_path), "unet")
    torch.save({"w": torch.zeros(1)}, tmp_path / "pytorch_model.bin")
    assert float(load_diffusers_folder_weights(str(tmp_path))["w"]) == 0
    torch.save({"w": torch.ones(1)}, tmp_path / "diffusion_pytorch_model.bin")
    assert float(load_diffusers_folder_weights(str(tmp_path))["w"]) == 1
    save_file({"w": torch.full((1,), 2.0)}, str(tmp_path / "diffusion_pytorch_model.safetensors"))
    assert float(load_diffusers_folder_weights(str(tmp_path))["w"]) == 2


def test_each_artifact_is_strict_against_itself(tiny_files, tmp_path):
    """A loader consumes every key of its file (buffers and the dropped
    ``text_projection`` aside), and a stray key in any file raises."""
    from cvd_tpu_torch.cli import build
    from cvd_tpu_torch.io import checkpoints as C
    from cvd_tpu_torch.io.torch_io import load_torch_state
    from cvd_tpu_torch.pipelines.common import PipelineModules

    paths, _ = tiny_files
    m = PipelineModules.create(build.SMOKE_UNET, build.SMOKE_VAE, build.SMOKE_CLIP,
                               generator=torch.Generator().manual_seed(0))
    report = C.load_sd_pipeline_weights(
        m.unet, m.vae, m.clip, paths["ori_model_path"],
        motion_module_ckpt=paths["motion_module_ckpt"], epi_module_ckpt=paths["epi_module_ckpt"],
        pose_adaptor_ckpt=paths["pose_adaptor_ckpt"], pose_encoder=m.pose_encoder)
    assert list(report) == ["unet", "vae", "text_encoder", "motion_module", "epi_module",
                            "pose_adaptor"]
    n_unet = len(load_torch_state(os.path.join(paths["ori_model_path"], "unet",
                                               "diffusion_pytorch_model.bin")))
    mm = load_torch_state(paths["motion_module_ckpt"])
    n_pe = sum(k.endswith("pos_encoder.pe") for k in mm)
    n_merge = len(load_torch_state(paths["pose_adaptor_ckpt"], "attention_processor_state_dict"))
    assert report["unet"]["keys"] == n_unet and report["motion_module"]["keys"] == len(mm)
    assert n_pe == 40 and n_merge == 40
    # the four UNet artifacts fill the UNet exactly once (the buffers aside)
    assert (n_unet + len(mm) - n_pe + report["epi_module"]["keys"] + n_merge
            == len(m.unet.state_dict()))
    # the decode-only VAE takes the decoder's keys; with the encoder, all
    full = PipelineModules.create(build.SMOKE_UNET, build.SMOKE_VAE, build.SMOKE_CLIP,
                                  generator=torch.Generator().manual_seed(0), vae_encoder=True)
    assert len(C.load_vae_weights(full.vae, paths["ori_model_path"])) == len(full.vae.state_dict())
    assert report["vae"]["keys"] == len(m.vae.state_dict()) < len(full.vae.state_dict())

    epi = torch.load(paths["epi_module_ckpt"], weights_only=True)
    epi["unet_trainable_dict"]["down_blocks.0.epi_modules.0.stray.weight"] = torch.zeros(2)
    torch.save(epi, tmp_path / "epi_bad.ckpt")
    with pytest.raises(KeyError, match="stray"):
        C.load_epi_module_weights(m.unet, str(tmp_path / "epi_bad.ckpt"))
    with pytest.raises(ValueError, match="pose encoder"):
        C.load_sd_pipeline_weights(m.unet, m.vae, m.clip, paths["ori_model_path"],
                                   pose_adaptor_ckpt=paths["pose_adaptor_ckpt"])


def test_a_trained_checkpoint_loads_back(tiny_files, port_modules, tmp_path):
    """``save_reference_ckpt`` writes what ``load_epi_module_weights`` reads."""
    from cvd_tpu_torch.io.checkpoints import load_epi_module_weights
    from cvd_tpu_torch.train.checkpoint import save_reference_ckpt
    from cvd_tpu_torch.train.state import TrainState, trainable_mask

    unet = port_modules.unet
    names = [n for n, keep in trainable_mask([n for n, _ in unet.named_parameters()]).items()
             if keep]
    state = TrainState(unet, None, None, names, 1.0)
    save_reference_ckpt(str(tmp_path / "c.ckpt"), state, epoch=1, global_step=5)
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.models.unet import UNet3DConditionModel

    fresh = UNet3DConditionModel(SMOKE_UNET)
    consumed = load_epi_module_weights(fresh, str(tmp_path / "c.ckpt"))
    assert sorted(consumed) == sorted(names)
    want = unet.state_dict()
    assert all(torch.equal(fresh.state_dict()[n], want[n]) for n in names)


# ------------------------------------------------------------------ LoRA fusion

def _lora_pairs(rng, bases, projs, C, R, dtype=np.float32):
    lora = {}
    for base in bases:
        for proj in projs:
            lora[f"{base}.processor.{proj}_lora.down.weight"] = \
                rng.standard_normal((R, C)).astype(dtype)
            lora[f"{base}.processor.{proj}_lora.up.weight"] = \
                rng.standard_normal((C, R)).astype(dtype)
    return lora


def test_fuse_lora_into_unet_state_matches_jax():
    from cvd_tpu.io.lora import fuse_lora_into_unet_state as jax_fuse
    from cvd_tpu_torch.io.lora import fuse_lora_into_unet_state

    rng = np.random.default_rng(10)
    base = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    state = {f"{base}.{p}.weight": rng.standard_normal((32, 32)).astype(np.float32)
             for p in ("to_q", "to_k", "to_v", "to_out.0")}
    state[f"{base}.to_out.0.bias"] = rng.standard_normal(32).astype(np.float32)
    state["conv_in.weight"] = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    lora = _lora_pairs(rng, [base], ("to_q", "to_k", "to_out"), 32, 4)
    want = jax_fuse(state, lora, scale=0.5)
    got = fuse_lora_into_unet_state(_tensors(state), _tensors(lora), scale=0.5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert not torch.equal(got[f"{base}.to_q.weight"], torch.from_numpy(state[f"{base}.to_q.weight"]))
    assert torch.equal(got[f"{base}.to_v.weight"], torch.from_numpy(state[f"{base}.to_v.weight"]))
    with pytest.raises(KeyError):
        fuse_lora_into_unet_state(_tensors(state), {"unmatched.down.weight": torch.zeros(4, 32)})


def test_fuse_motion_lora_into_state_matches_jax():
    from cvd_tpu.io.lora import fuse_motion_lora_into_state as jax_fuse
    from cvd_tpu_torch.io.lora import fuse_motion_lora_into_state

    rng = np.random.default_rng(0)
    bases = [f"down_blocks.0.motion_modules.{j}.temporal_transformer.transformer_blocks.0."
             f"attention_blocks.{a}" for j in range(2) for a in range(2)]
    state = {}
    for base in bases:
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            state[f"{base}.{proj}.weight"] = rng.standard_normal((32, 32)).astype(np.float32)
    lora = _lora_pairs(rng, bases, ("to_q", "to_k", "to_v", "to_out"), 32, 4)
    want = jax_fuse(state, lora, scale=0.8)
    got = fuse_motion_lora_into_state(_tensors(state), _tensors(lora), scale=0.8)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert not np.array_equal(got[k].numpy(), state[k])
    # f16 files: the product in f32, the result in the target's dtype
    half = fuse_motion_lora_into_state({k: v.half() for k, v in _tensors(state).items()},
                                       {k: v.half() for k, v in _tensors(lora).items()}, 0.8)
    k = next(iter(state))
    assert half[k].dtype == torch.float16
    np.testing.assert_allclose(half[k].float().numpy(), want[k], atol=2e-2)
    bad = {k.replace("down_blocks.0", "nonexistent"): v for k, v in _tensors(lora).items()}
    with pytest.raises(KeyError, match="absent"):
        fuse_motion_lora_into_state(_tensors(state), bad)


def test_motion_lora_is_fused_at_load(tiny_files, port_modules, tmp_path):
    """``--motion_lora_ckpt`` (pairs under 'state_dict', as released) lands
    as W + scale * up @ down on the temporal projections it names."""
    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.io.checkpoints import load_motion_module_weights
    from cvd_tpu_torch.models.unet import UNet3DConditionModel

    paths, _ = tiny_files
    rng = np.random.default_rng(1)
    base = ("up_blocks.1.motion_modules.2.temporal_transformer.transformer_blocks.0."
            "attention_blocks.1")
    lora = _tensors(_lora_pairs(rng, [base], ("to_q", "to_out"), 64, 4))
    torch.save({"state_dict": lora}, tmp_path / "lora.ckpt")
    unet = UNet3DConditionModel(SMOKE_UNET)
    load_motion_module_weights(unet, paths["motion_module_ckpt"], str(tmp_path / "lora.ckpt"), 0.7)
    plain, got = port_modules.unet.state_dict(), unet.state_dict()
    for proj, key in (("to_q", f"{base}.to_q.weight"), ("to_out", f"{base}.to_out.0.weight")):
        up = lora[f"{base}.processor.{proj}_lora.up.weight"]
        down = lora[f"{base}.processor.{proj}_lora.down.weight"]
        assert torch.equal(got[key], plain[key] + 0.7 * (up @ down))
    assert torch.equal(got[f"{base}.to_k.weight"], plain[f"{base}.to_k.weight"])


def test_merge_lora_writes_a_folder_both_packages_load_alike(tiny_files, tmp_path):
    from cvd_tpu.cli import merge_lora as jax_merge
    from cvd_tpu.io.torch_io import load_diffusers_folder_weights as jax_load
    from cvd_tpu_torch.cli import merge_lora
    from cvd_tpu_torch.io.torch_io import load_diffusers_folder_weights

    paths, _ = tiny_files
    rng = np.random.default_rng(2)
    bases = ["down_blocks.0.attentions.0.transformer_blocks.0.attn1",
             "down_blocks.0.attentions.1.transformer_blocks.0.attn2"]
    lora = _tensors(_lora_pairs(rng, bases, ("to_q", "to_out"), 32, 4))
    torch.save(lora, tmp_path / "adapter.ckpt")
    with open(os.path.join(paths["ori_model_path"], "unet", "config.json"), "w") as f:
        f.write("{}")
    argv = ["--base_path", paths["ori_model_path"], "--lora_ckpt", str(tmp_path / "adapter.ckpt"),
            "--lora_scale", "0.5"]
    merge_lora.main(merge_lora.build_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "port")]))
    jax_merge.main(jax_merge.build_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "jax")]))
    sub = "unet_webvidlora_v3"
    assert os.path.exists(tmp_path / "port" / sub / "config.json")
    got = load_diffusers_folder_weights(str(tmp_path / "port" / sub))
    for loaded in (jax_load(str(tmp_path / "jax" / sub)), jax_load(str(tmp_path / "port" / sub))):
        assert set(got) == set(loaded)
        for k, v in loaded.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6, atol=1e-6, err_msg=k)
    base = load_diffusers_folder_weights(os.path.join(paths["ori_model_path"], "unet"))
    changed = [k for k in got if not torch.equal(got[k], base[k])]
    assert sorted(changed) == sorted(f"{b}.{p}.weight" for b in bases for p in ("to_q", "to_out.0"))


# ------------------------------------------------- model config and scheduler

def test_load_model_config_matches_jax_field_by_field():
    from cvd_tpu.io.model_config import load_model_config as jax_load
    from cvd_tpu_torch.io.model_config import load_model_config

    path = os.path.join(REPO, "configs", "inference_config.yaml")
    jc, jpose, jsched, jextra = jax_load(path, F_mat_size=256)
    pc, ppose, psched, pextra = load_model_config(path, F_mat_size=256)
    mine = dataclasses.asdict(pc)
    theirs = dataclasses.asdict(jc)
    # the SDXL backbone's fields, which cvd_tpu has none of, keep SD1.5's values
    sdxl = ("transformer_layers_per_block", "mid_transformer_layers", "spatial_heads",
            "use_linear_projection", "addition_embed_type", "addition_time_embed_dim",
            "projection_class_embeddings_input_dim")
    from cvd_tpu_torch.models.unet import UNetConfig

    assert {f: mine.pop(f) for f in sdxl} == {f: getattr(UNetConfig(), f) for f in sdxl}
    assert pextra["backbone"] is None
    assert len(mine) >= 20 and set(mine) <= set(theirs)
    for field, value in mine.items():
        assert value == theirs[field], field
    assert ppose == jpose
    theirs = dataclasses.asdict(jsched)
    # what the port fixes (epsilon prediction, a final alpha of 1) is what the config gives
    assert (theirs.pop("prediction_type"), theirs.pop("set_alpha_to_one")) == ("epsilon", True)
    assert dataclasses.asdict(psched) == theirs
    assert pextra["epi_F_mat_size"] == jextra["epi_F_mat_size"] == 256
    assert pextra["raw"] == jextra["raw"]


def test_model_config_sets_what_the_yaml_says(tmp_path):
    import yaml

    from cvd_tpu_torch.cli.build import SMOKE_UNET
    from cvd_tpu_torch.io.model_config import load_model_config

    with open(os.path.join(REPO, "configs", "inference_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["unet_additional_kwargs"]["motion_module_kwargs"]["zero_initialize"] = True
    raw["unet_additional_kwargs"]["epi_module_resolutions"] = [1, 2]
    raw["attention_processor_kwargs"]["scale"] = 0.5
    raw["pose_encoder_kwargs"]["temporal_position_encoding_max_len"] = 24
    raw["noise_scheduler_kwargs"].update(beta_schedule="scaled_linear", clip_sample=True)
    path = tmp_path / "m.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg, pose, sched, _ = load_model_config(str(path), base=SMOKE_UNET)
    assert cfg.block_out_channels == SMOKE_UNET.block_out_channels   # widths: the base's
    assert cfg.motion_zero_initialize and cfg.epi_module_resolutions == (1, 2)
    assert cfg.pose_scale == 0.5 and pose["temporal_pe_max_len"] == 24
    assert sched.beta_schedule == "scaled_linear" and sched.clip_sample
    # the auxiliary q/k head: built from the yaml, its keys load from an epi
    # checkpoint (training writes them there) and nowhere else
    from cvd_tpu_torch.io.checkpoints import load_epi_module_weights
    from cvd_tpu_torch.models.unet import UNet3DConditionModel

    raw["unet_additional_kwargs"]["additional_channel"] = 4
    path.write_text(yaml.safe_dump(raw))
    cfg, _, _, _ = load_model_config(str(path), base=SMOKE_UNET)
    assert cfg.additional_channel == 4
    unet = UNet3DConditionModel(cfg)
    head = {k: torch.randn(v.shape) for k, v in unet.state_dict().items() if "auxiliary" in k}
    assert sorted(head) == ["conv_auxiliary_key.bias", "conv_auxiliary_key.weight",
                            "conv_auxiliary_query.bias", "conv_auxiliary_query.weight"]
    assert head["conv_auxiliary_query.weight"].shape == (4, 32, 1, 1)
    ckpt = tmp_path / "epi.ckpt"
    torch.save({"epoch": 0, "global_step": 1, "unet_trainable_dict": head}, ckpt)
    assert sorted(load_epi_module_weights(unet, str(ckpt))) == sorted(head)
    assert all(torch.equal(unet.state_dict()[k], v) for k, v in head.items())
    with pytest.raises(KeyError, match="conv_auxiliary"):
        load_epi_module_weights(UNet3DConditionModel(SMOKE_UNET), str(ckpt))


@pytest.mark.parametrize("fields", [
    dict(beta_schedule="scaled_linear"),
    dict(clip_sample=True),
    dict(steps_offset=0),
    dict(beta_schedule="scaled_linear", clip_sample=True),
    dict(beta_schedule="scaled_linear", clip_sample=True, steps_offset=0),
])
def test_scheduler_fields_match_jax(fields):
    from cvd_tpu.schedulers.ddim import DDIMScheduler as JD
    from cvd_tpu_torch.schedulers.ddim import DDIMScheduler as PD

    steps = 4
    jd, pd = JD(**fields), PD(**fields)
    js, ps = jd.set_timesteps(steps), pd.set_timesteps(steps)
    np.testing.assert_array_equal(np.asarray(js.timesteps), ps.timesteps)
    np.testing.assert_allclose(ps.alphas_cumprod, np.asarray(js.alphas_cumprod), rtol=1e-6)
    np.testing.assert_allclose(ps.final_alpha_cumprod, np.asarray(js.final_alpha_cumprod),
                               rtol=1e-6)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 3, 4)) * 2).astype(np.float32)
    eps = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for ts in ps.timesteps:     # the last step reaches final_alpha_cumprod
        want = jd.step(js, jnp.asarray(eps), jnp.asarray(ts), jnp.asarray(x))
        got = pd.step(ps, torch.from_numpy(eps), int(ts), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    defaults = PD()
    assert (defaults.beta_schedule, defaults.clip_sample) == ("linear", False)


def test_scheduler_refuses_unknown_values():
    from cvd_tpu_torch.schedulers.ddim import DDIMScheduler

    with pytest.raises(ValueError):
        DDIMScheduler(beta_schedule="cosine").set_timesteps(2)
    with pytest.raises(TypeError):      # epsilon prediction is fixed, not a field
        DDIMScheduler(prediction_type="v_prediction")

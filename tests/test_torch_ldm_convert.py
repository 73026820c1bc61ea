"""civitai / LDM import and kohya LoRA fusion of cvd_tpu_torch against
cvd_tpu's, on the CPU.

* Keys: each converter over the full-size LDM manifests gives exactly
  cvd_tpu's keys, and (after the VAE and CLIP renames) exactly the port's
  full-size module keys on the ``meta`` device.
* Values at the tiny widths: the tiny modules' drawn state dicts written as
  one LDM file through the LDM -> diffusers key map of the full-size
  manifests (the VAE's mid attention as 1x1 convolutions, plus
  ``model_ema.*``, ``alphas_cumprod`` and a ``text_projection`` that the
  import must not read), and a kohya LoRA (rank 2, ``.alpha`` entries, the
  attention projections, the 1x1-conv ``proj_in`` / ``proj_out``, ``ff``
  and the text encoder's projections under their transformers names,
  ``lora_te_text_model_encoder_*``). Both packages' ``build_modules`` take
  ``civitai_base_model`` + ``civitai_lora_ckpt`` over the same tiny
  checkpoint files: every parameter agrees and so does a UNet forward (f32,
  1e-5 x max|ref|). cvd_tpu resolves the text encoder's pairs against names
  without ``encoder.`` and so raises on them (the last test); it is given
  the file's UNet pairs alone, which gives the same weights, since both
  packages compute the text encoder's fusion and drop it.
* The kohya key resolver: unique over the full-size port UNet (motion, epi
  and pose modules included) and CLIP for every key of a full SD1.5 LoRA,
  and the separator-stripping fallback finds ``time_embedding.linear_1``
  (the port's name) and ``time_embedding.linear.1`` (cvd_tpu's export) alike.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_checkpoints import model_args, perturbed, write_tiny_checkpoints  # noqa: E402

torch.set_num_threads(2)

Fr, S = 2, 8  # frames, latent size
REL_TOL = 1e-5
ALPHA = 0.6   # apply_civitai_lora's default, as the entry points fuse
# the UNet layers a kohya SD1.5 LoRA trains: every spatial attention's
# projections, the transformers' 1x1-conv proj_in / proj_out and ff
KOHYA_UNET = (".to_q.weight", ".to_k.weight", ".to_v.weight", ".to_out.0.weight",
              ".proj_in.weight", ".proj_out.weight", ".ff.net.0.proj.weight",
              ".ff.net.2.weight")
KOHYA_TE = (".q_proj.weight", ".k_proj.weight", ".v_proj.weight", ".out_proj.weight")


# ------------------------------------------------------------- the key maps

def _ldm_maps():
    """{LDM key: the port's key} for the UNet, the VAE and CLIP, from
    the full-size manifests, one key at a time."""
    from cvd_tpu_torch.io import ldm_convert as L
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import clip_rename, vae_legacy_rename

    def pairs(convert, manifest, rename=lambda k: k):
        # the conversions keep the order of the keys, one out for each in
        out = convert(dict.fromkeys(manifest))
        assert len(out) == len(manifest)
        return {k: rename(o) for k, o in zip(manifest, out)}

    return {"unet": pairs(L.convert_ldm_unet_state, M.ldm_sd15_unet_manifest()),
            "vae": pairs(L.convert_ldm_vae_state, M.ldm_sd15_vae_manifest(), vae_legacy_rename),
            "clip": pairs(L.convert_ldm_clip_state, M.ldm_sd15_clip_manifest(), clip_rename)}


def _full_size():
    from cvd_tpu_torch.pipelines.common import PipelineModules

    return PipelineModules.create(device="meta", vae_encoder=True)


@pytest.mark.parametrize("name", ["unet", "vae", "clip"])
def test_converters_give_cvd_tpus_keys_and_the_ports(name):
    from cvd_tpu.io import ldm_convert as JL
    from cvd_tpu.io import manifests as JM
    from cvd_tpu_torch.io import ldm_convert as L
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import (
        SKIP_SUBSTRINGS, clip_rename, merge_torch_state, vae_legacy_rename,
    )

    manifest = getattr(M, f"ldm_sd15_{name}_manifest")()
    assert manifest == getattr(JM, f"ldm_sd15_{name}_manifest")()
    junk = {"model_ema.decay": (1,), "alphas_cumprod": (1000,), "betas": (1000,)}
    state = M.zeros_state({**manifest, **junk})
    got = getattr(L, f"convert_ldm_{name}_state")(state)
    want = getattr(JL, f"convert_ldm_{name}_state")(state)
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in got)

    rename = {"unet": None, "vae": vae_legacy_rename, "clip": clip_rename}[name]
    module = getattr(_full_size(), name)
    params = {k: tuple(p.shape) for k, p in module.named_parameters()}
    keys = {(rename(k) if rename else k) for k in got}
    keys = {k for k in keys if not any(s in k for s in SKIP_SUBSTRINGS)}
    if name == "unet":   # the spatial part: exactly the SD1.5 UNet file's keys
        assert keys == set(M.sd15_unet_manifest()) and keys <= set(params)
    else:
        assert keys == set(params)
    shapes = {k: torch.empty(v.shape, device="meta") for k, v in got.items()}
    assert len(merge_torch_state(module, shapes, rename=rename)) == len(shapes)


def test_a_full_sd15_kohya_lora_resolves_to_one_key_each():
    """Every kohya key of a full SD1.5 UNet + text-encoder LoRA names exactly
    the tensor it was made from, over the port's whole full-size UNet
    (motion, epi and pose modules included) and the transformers CLIP names."""
    from cvd_tpu_torch.io import manifests as M
    from cvd_tpu_torch.io.checkpoints import clip_hf_name
    from cvd_tpu_torch.io.lora import _kohya_resolver

    full = _full_size()
    unet = dict(full.unet.state_dict())
    te = {clip_hf_name(k): v for k, v in full.clip.state_dict().items()}
    cases = [(unet, [k for k in M.sd15_unet_manifest() if k.endswith(KOHYA_UNET)]),
             (te, [k for k in M.sd15_clip_manifest() if k.endswith(KOHYA_TE)])]
    for state, targets in cases:
        resolve = _kohya_resolver(state)
        assert targets
        for key in targets:
            assert resolve(key[: -len(".weight")].replace(".", "_")) == key
    # 16 transformers: 8 attention projections, 2 ff layers, proj_in and proj_out
    assert len(cases[0][1]) == 16 * 12
    assert len(cases[1][1]) == 12 * 4


def test_the_fallback_finds_linear_1_and_linear_dot_1():
    """The port names the time embedding ``linear_1`` (the checkpoints'
    name), cvd_tpu's ``export_torch_state`` ``linear.1``: one kohya key
    reaches either."""
    from cvd_tpu_torch.io.lora import _kohya_resolver

    w = torch.zeros(2, 2)
    port = {"time_embedding.linear_1.weight": w, "time_embedding.linear_2.weight": w}
    jax_names = {"time_embedding.linear.1.weight": w, "time_embedding.linear.2.weight": w}
    assert _kohya_resolver(port)("time_embedding_linear_1") == "time_embedding.linear_1.weight"
    assert (_kohya_resolver(jax_names)("time_embedding_linear_1")
            == "time_embedding.linear.1.weight")
    both = {**port, **jax_names}   # two matches: refused, never a guess
    assert _kohya_resolver(both)("time_embedding_linear_1") is None


def test_kohya_fusion_matches_jax_and_an_unknown_key_raises():
    from cvd_tpu.io.lora import fuse_kohya_lora_into_pipeline as jax_fuse
    from cvd_tpu_torch.io.lora import fuse_kohya_lora_into_pipeline

    rng = np.random.default_rng(5)
    unet = {"a.attn1.to_q.weight": rng.standard_normal((6, 4)).astype(np.float32),
            "a.proj_in.weight": rng.standard_normal((6, 6, 1, 1)).astype(np.float32),
            "a.proj_in.bias": rng.standard_normal(6).astype(np.float32)}
    te = {"text_model.encoder.layers.0.self_attn.q_proj.weight":
          rng.standard_normal((4, 4)).astype(np.float32)}
    lora = {
        "lora_unet_a_attn1_to_q.lora_down.weight": rng.standard_normal((2, 4)),
        "lora_unet_a_attn1_to_q.lora_up.weight": rng.standard_normal((6, 2)),
        "lora_unet_a_attn1_to_q.alpha": np.array(3.0),
        "lora_unet_a_proj_in.lora_down.weight": rng.standard_normal((2, 6, 1, 1)),
        "lora_unet_a_proj_in.lora_up.weight": rng.standard_normal((6, 2, 1, 1)),
        "lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight":
            rng.standard_normal((2, 4)),
        "lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight":
            rng.standard_normal((4, 2)),
    }
    lora = {k: np.asarray(v, np.float32) for k, v in lora.items()}
    want = jax_fuse(unet, te, lora, ALPHA)
    t = {k: torch.from_numpy(v) for k, v in unet.items()}
    tte = {k: torch.from_numpy(v) for k, v in te.items()}
    got = fuse_kohya_lora_into_pipeline(t, tte, {k: torch.from_numpy(v) for k, v in lora.items()},
                                        ALPHA)
    for part in ("unet", "text_encoder"):
        assert set(got[part]) == set(want[part])
        for k, v in got[part].items():
            np.testing.assert_allclose(v.numpy(), want[part][k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert got["unet"]["a.proj_in.bias"] is t["a.proj_in.bias"]   # untouched, not copied
    lora["lora_unet_b_to_k.lora_down.weight"] = lora["lora_unet_a_attn1_to_q.lora_down.weight"]
    with pytest.raises(KeyError, match="lora_unet_b_to_k"):
        fuse_kohya_lora_into_pipeline(t, tte, {k: torch.from_numpy(v) for k, v in lora.items()})


# --------------------------------------------------- the tiny civitai files

def write_tiny_civitai(root, seed=0):
    """An LDM single-file model of the tiny widths (``cli.build.SMOKE_WIDTHS``)
    and a kohya LoRA over it, drawn from ``seed`` -> (model path, LoRA path,
    the LoRA's state, {module: {port key: tensor}} the model holds). Written
    with ``torch.save`` (the model's state under ``state_dict``, as civitai
    ``.ckpt`` files have it)."""
    from cvd_tpu_torch.cli.build import SMOKE_WIDTHS
    from cvd_tpu_torch.pipelines.common import PipelineModules

    rng = np.random.default_rng(seed)
    meta = PipelineModules.create(*SMOKE_WIDTHS, device="meta", vae_encoder=True)
    values, ldm = {}, {}
    for name, ldm_to_port in _ldm_maps().items():
        # the UNet's spatial layers; every parameter of the VAE and CLIP
        params = {k: p.shape for k, p in getattr(meta, name).named_parameters()
                  if name != "unet" or k in ldm_to_port.values()}
        values[name] = {k: torch.from_numpy(
            (rng.standard_normal(tuple(shape)) * (0.5 / max(1, np.prod(shape[1:])) ** 0.5
                                                  if len(shape) > 1 else 0.1)
             + (1.0 if len(shape) == 1 and k.endswith(".weight") else 0.0)
             ).astype(np.float32)) for k, shape in params.items()}
        covered = set()
        for ldm_key, port_key in ldm_to_port.items():
            if port_key.endswith("position_ids"):
                ldm[ldm_key] = torch.arange(77)[None]
            elif port_key in values[name]:
                v = values[name][port_key]
                if name == "vae" and ".mid.attn_1." in ldm_key and v.ndim == 2:
                    v = v[:, :, None, None]     # CompVis stores them as 1x1 convolutions
                ldm[ldm_key] = v
                covered.add(port_key)
        assert covered == set(values[name]), sorted(set(values[name]) - covered)[:5]
    ldm["model_ema.decay"] = torch.tensor(0.9999)
    ldm["alphas_cumprod"] = torch.rand(1000, generator=torch.Generator().manual_seed(seed))
    ldm["cond_stage_model.transformer.text_projection.weight"] = torch.zeros(4, 4)

    lora = {}
    for prefix, state in (("lora_unet_", values["unet"]), ("lora_te_", {
            k: v for k, v in ((f"text_model.encoder.{k}" if k.startswith("layers.") else k, v)
                              for k, v in values["clip"].items())})):
        ends = KOHYA_UNET if prefix == "lora_unet_" else KOHYA_TE
        for key, w in state.items():
            if not key.endswith(ends):
                continue
            stem = prefix + key[: -len(".weight")].replace(".", "_")
            tail = (1, 1) if w.ndim == 4 else ()
            lora[f"{stem}.lora_down.weight"] = torch.from_numpy(
                rng.standard_normal((2, w.shape[1]) + tail).astype(np.float32) * 0.3)
            lora[f"{stem}.lora_up.weight"] = torch.from_numpy(
                rng.standard_normal((w.shape[0], 2) + tail).astype(np.float32) * 0.3)
            lora[f"{stem}.alpha"] = torch.tensor(float(rng.integers(1, 5)))
    model, lora_path = os.path.join(str(root), "civitai.ckpt"), os.path.join(str(root),
                                                                              "kohya.ckpt")
    torch.save({"state_dict": ldm, "global_step": 7}, model)
    torch.save(lora, lora_path)
    return model, lora_path, lora, values


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from cvd_tpu.pipelines.common import PipelineModules
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    root = tmp_path_factory.mktemp("civitai")
    base = PipelineModules.create(unet_config=TINY_UNET, vae_config=TINY_VAE,
                                  clip_config=TINY_CLIP, latent_size=S, video_length=Fr,
                                  fast_init=True)
    paths = write_tiny_checkpoints(root, perturbed(base.unet_params, 20),
                                   perturbed(base.vae_params, 21), perturbed(base.clip_params, 22),
                                   perturbed(base.pose_encoder_params, 23))
    model, lora_path, lora, values = write_tiny_civitai(root)
    unet_pairs = str(root / "kohya_unet.ckpt")
    torch.save({k: v for k, v in lora.items() if k.startswith("lora_unet_")}, unet_pairs)
    return dict(paths, civitai_base_model=model, civitai_lora_ckpt=lora_path), values, unet_pairs


@pytest.fixture(scope="module")
def built(files):
    """(cvd_tpu's bundle, the port's), each from its own ``build_modules``
    over the same files: cvd_tpu's at the tiny widths with the hash
    tokenizer and its fast init (every tensor comes from a file)."""
    import cvd_tpu.cli.build as jbuild
    import cvd_tpu.io.tokenizer as jtok
    from tiny import TINY_CLIP, TINY_UNET, TINY_VAE

    from cvd_tpu_torch.cli import build
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    paths, _, unet_pairs = files
    mp = pytest.MonkeyPatch()
    create = jbuild.PipelineModules.create
    mp.setattr(jbuild.PipelineModules, "create", lambda **kw: create(**{**kw, "fast_init": True}))
    mp.setattr(jbuild, "UNetConfig", lambda **kw: dataclasses.replace(TINY_UNET, **kw))
    mp.setattr(jbuild, "VAEConfig", lambda: TINY_VAE)
    mp.setattr(jbuild, "CLIPTextConfig", lambda: TINY_CLIP)
    mp.setattr(jbuild, "enable_compilation_cache", lambda: None)
    mp.setattr(jtok, "get_tokenizer", lambda folder: HashTokenizer())
    try:
        jm, _ = jbuild.build_modules(model_args(paths, civitai_lora_ckpt=unet_pairs), Fr, 8 * S)
    finally:
        mp.undo()
    report = {}
    pm, _ = build.build_modules(model_args(paths), torch.device("cpu"), tokenizer=HashTokenizer(),
                                widths=build.SMOKE_WIDTHS, report=report)
    return jm, pm, report


def test_build_modules_take_the_civitai_files_like_cvd_tpu(built, files):
    """Every parameter of the port's bundle equals cvd_tpu's after the same
    files, the civitai base model and its LoRA; the spatial weights are the
    civitai file's (the LoRA fused over the UNet only), the motion / epi /
    pose weights the checkpoint files'."""
    from cvd_tpu_torch.io.from_flax import state_dict_from_flax

    jm, pm, report = built
    _, values, _ = files
    assert report["civitai_base_model"]["keys"] > 0 and report["civitai_lora"]["keys"] > 0
    for name, tree in (("unet", jm.unet_params), ("clip", jm.clip_params),
                       ("pose_encoder", jm.pose_encoder_params), ("vae", jm.vae_params)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        got = getattr(pm, name).state_dict()
        assert set(got) <= set(want) and (name == "vae" or set(got) == set(want))
        for key, value in got.items():
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=REL_TOL,
                                       atol=REL_TOL * float(want[key].abs().max()),
                                       err_msg=f"{name}.{key}")
    unet = pm.unet.state_dict()
    fused = [k for k in values["unet"] if k.endswith(KOHYA_UNET)]
    assert report["civitai_lora"]["keys"] == len(fused)
    for k, v in values["unet"].items():
        assert torch.equal(unet[k], v) != (k in fused), k
    # the text encoder's fusion is computed and dropped, as in cvd_tpu
    assert all(torch.equal(pm.clip.state_dict()[k], v) for k, v in values["clip"].items())
    assert all(torch.equal(pm.vae.state_dict()[k], values["vae"][k])
               for k in pm.vae.state_dict())


def test_unet_forward_from_the_civitai_build_matches_jax(built):
    from cvd_tpu.models.pose_adaptor import PoseAdaptor as JaxPoseAdaptor
    from cvd_tpu_torch.models.pose_adaptor import PoseAdaptor

    jm, pm, _ = built
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((2, Fr, S, S, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, jm.unet.config.cross_attention_dim)).astype(np.float32)
    plucker = rng.standard_normal((2, Fr, 8 * S, 8 * S, 6)).astype(np.float32)
    F_mats = (rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)
    t = np.array([901, 401], dtype=np.int32)
    want, _ = JaxPoseAdaptor(jm, F_mat_size=256, rand_slope_ff=False)(
        jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(plucker),
        jnp.asarray(F_mats))
    with torch.no_grad():
        got = PoseAdaptor(pm, F_mat_size=256, rand_slope_ff=False)(
            torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
            torch.from_numpy(plucker), torch.from_numpy(F_mats))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL_TOL * np.abs(want).max())


def test_a_key_the_model_lacks_raises(files, tmp_path):
    """A civitai key that lands nowhere is an error, never skipped."""
    from cvd_tpu_torch.cli.build import SMOKE_WIDTHS
    from cvd_tpu_torch.io.ldm_convert import load_civitai_base_model
    from cvd_tpu_torch.pipelines.common import PipelineModules

    paths, _, _ = files
    state = torch.load(paths["civitai_base_model"], weights_only=True)["state_dict"]
    state["model.diffusion_model.input_blocks.1.1.extra.weight"] = torch.zeros(2)
    bad = str(tmp_path / "bad.ckpt")
    torch.save(state, bad)
    m = PipelineModules.create(*SMOKE_WIDTHS, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        load_civitai_base_model(m, bad)


def test_cvd_tpu_cannot_resolve_the_text_encoders_pairs(files):
    """A kohya LoRA names the text encoder's layers as transformers does
    (``text_model.encoder.layers``); cvd_tpu resolves them against its own
    export, which has no ``encoder.``, and raises. The port resolves them and
    then drops the text encoder's fusion, as cvd_tpu would have."""
    from cvd_tpu.io.lora import fuse_kohya_lora_into_pipeline as jax_fuse
    from cvd_tpu_torch.io.torch_io import load_torch_state

    paths, _, _ = files
    lora = {k: v.numpy() for k, v in load_torch_state(paths["civitai_lora_ckpt"]).items()}
    te = {k: v for k, v in lora.items() if k.startswith("lora_te_")}
    assert te and all(k.startswith("lora_te_text_model_encoder_layers_") for k in te)
    names = {"text_model.layers.0.self_attn.q_proj.weight": np.zeros((24, 24), np.float32)}
    with pytest.raises(KeyError, match="lora_te_text_model_encoder"):
        jax_fuse({}, names, te)

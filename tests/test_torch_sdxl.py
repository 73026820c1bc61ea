"""CVD on the SDXL backbone in cvd_tpu_torch against the benchmark's plain
float32 reference (``port_bench/reference/model_sdxl.py``), on the CPU at
the tiny configuration ``port_bench/configs/tiny-sdxl-cpu.json``, from the
same seeded weights: the UNet (a level without attention, depth 2 at one
level, 8-wide spatial heads beside the motion and epi modules' 4, Linear
projections, the ``text_time`` embedding), both text encoders (penultimate
states, the pooled projection at the first EOS, GELU beside quick-GELU),
``encode_prompt``'s joined context, and a 2-step 2-view request through
``SimplePipeline`` run eagerly; ``AdvancedPipeline`` refuses this UNet
before any draw. Also: a default ``UNetConfig`` builds
SD1.5's keys and shapes, and the inference CLI builds and samples from a
model config with a ``backbone`` section."""
import json
import math
import os

import pytest
import torch

from cvd_tpu_torch.io import manifests as M
from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from cvd_tpu_torch.pipelines.common import encode_prompt
from cvd_tpu_torch.pipelines.simple import SimplePipeline
from port_bench.lib import names, port
from port_bench.reference import model as ref_model
from port_bench.reference import model_sdxl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = names.config("tiny-sdxl-cpu")
SEED = 3_000_000_023
FRAMES, SIZE = 2, 64


@pytest.fixture(scope="module")
def both():
    torch.manual_seed(0)
    return port.build_modules(TINY, SEED, "cpu"), port.reference_modules(TINY, SEED, "cpu")


def _close(a, b, tol=1e-4):
    a, b = a.detach().double(), b.detach().double()
    assert a.shape == b.shape
    assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


def _ids(n_words: int) -> torch.Tensor:
    """[1, 77]: BOS, words, EOS, then EOS padding (the largest id)."""
    ids = torch.full((1, 77), 49407)
    ids[0, 0] = 49406
    ids[0, 1:1 + n_words] = torch.arange(1, 1 + n_words) * 97
    return ids


def test_default_unet_config_builds_sd15():
    """The released SD1.5 files' keys, shapes and nothing else: the SD
    folder's UNet, the motion module (its PE buffers are not the port's),
    the epi file and the pose adaptor's processors."""
    with torch.device("meta"):
        sd = UNet3DConditionModel(UNetConfig()).state_dict()
    want = {**M.sd15_unet_manifest(), **M.animatediff_v3_mm_manifest(),
            **M.cvd_epi_ckpt_manifest(), **M.cameractrl_attention_processor_manifest()}
    want = {k: s for k, s in want.items() if "pos_encoder" not in k}
    assert {k: tuple(t.shape) for k, t in sd.items()} == {k: tuple(s) for k, s in want.items()}


def test_unet(both):
    prog, ref = both
    cfg = TINY["unet"]
    g = torch.Generator().manual_seed(1)
    B, lat = 4, SIZE // 8
    sample = torch.randn(B, FRAMES, lat, lat, 4, generator=g)
    t = torch.tensor([999, 999, 500, 500])
    text = torch.randn(B, 77, cfg["cross_attention_dim"], generator=g)
    pooled = torch.randn(B, TINY["clip_2"]["projection_dim"], generator=g)
    time_ids = model_sdxl.time_ids(SIZE, B, "cpu")
    plucker = torch.randn(B, FRAMES, SIZE, SIZE, 6, generator=g)
    F_mats = torch.randn(B * FRAMES, 3, 3, generator=g)
    slope = torch.rand(1, generator=g) * math.pi
    with torch.no_grad():
        pose_p, pose_r = prog.pose_encoder(plucker), ref["pose_encoder"](plucker)
        for a, b in zip(pose_p, pose_r):
            _close(a, b)
        out = prog.unet(sample, t, text, list(pose_p),
                        EpiConditioning(F_mats=F_mats, video_length=FRAMES,
                                        F_mat_size=TINY["epi_F_mat_size"], slope=slope),
                        added_cond={"text_embeds": pooled, "time_ids": time_ids})
        want = ref["unet"](sample, t, text, pose_r,
                           ref_model.EpiCond(F_mats, FRAMES, TINY["epi_F_mat_size"],
                                             slope=slope), pooled, time_ids)
    _close(out, want)
    # what the tiny configuration exercises
    assert prog.unet.down_blocks[0].attentions is None
    assert len(prog.unet.down_blocks[1].attentions[0].transformer_blocks) == 2
    assert prog.unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1.heads == 8
    assert prog.unet.down_blocks[1].epi_modules is not None
    assert tuple(prog.unet.state_dict()["down_blocks.1.attentions.0.proj_in.weight"].shape) \
        == (64, 64)
    with torch.no_grad():    # the added embedding takes part
        other = prog.unet(sample, t, text, list(pose_p),
                          EpiConditioning(F_mats=F_mats, video_length=FRAMES,
                                          F_mat_size=TINY["epi_F_mat_size"], slope=slope),
                          added_cond={"text_embeds": pooled, "time_ids": 2 * time_ids})
    assert (other - out).abs().max() > 1e-3


@pytest.mark.parametrize("encoder", ["clip", "clip_2"])
def test_text_encoders(both, encoder):
    prog, ref = both
    ids = torch.cat([_ids(5), _ids(9)])
    with torch.no_grad():
        states, pooled = getattr(prog, encoder).encode(ids)
        want_states, want_pooled = ref[encoder].encode(ids)
    _close(states, want_states)
    if encoder == "clip":
        assert pooled is None and want_pooled is None
        assert getattr(prog, encoder).layers[0].mlp.act.__name__ == "quick_gelu"
        return
    _close(pooled, want_pooled)
    assert getattr(prog, encoder).layers[0].mlp.act is torch.nn.functional.gelu
    # the pooled state is the first EOS's: ids after it do not move it
    late = ids.clone()
    late[:, 40] = 123
    with torch.no_grad():
        _close(getattr(prog, encoder).encode(late)[1], pooled)
        full = prog.clip_2.final_layer_norm(prog.clip_2._layers(ids)[0])
    _close(pooled, prog.clip_2.text_projection(full[torch.arange(2), torch.tensor([6, 10])]))


def test_encode_prompt_joins_both(both):
    prog, ref = both
    with torch.no_grad():
        uncond, cond, pool_u, pool_c = encode_prompt(prog, _ids(7), _ids(3))
        for got, pool, ids in ((uncond, pool_u, _ids(3)), (cond, pool_c, _ids(7))):
            want, want_pool = model_sdxl.encode_text(ref, ids)
            assert got.shape[-1] == TINY["unet"]["cross_attention_dim"]
            _close(got, want)
            _close(pool, want_pool)


def test_request(both):
    prog, ref = both
    arch = names.architecture("cvd_sdxl")
    g = torch.Generator().manual_seed(2)
    plucker = torch.randn(2, FRAMES, SIZE, SIZE, 6, generator=g)
    F_mats = torch.randn(2, FRAMES, 3, 3, generator=g)
    latents = torch.randn(2, FRAMES, SIZE // 8, SIZE // 8, 4, generator=g)
    pipe = SimplePipeline(prog, F_mat_size=TINY["epi_F_mat_size"], capture=False)
    got = pipe(_ids(4), _ids(2), plucker, F_mats, num_inference_steps=2, guidance_scale=8.5,
               generator=torch.Generator().manual_seed(3), latents=latents)
    want = arch.reference_request(ref, TINY, _ids(4), _ids(2), plucker, F_mats, latents,
                                  torch.Generator().manual_seed(3), 2, 8.5)
    _close(got, want, 1e-3)
    assert set(pipe.sublayers.elapsed_ms()) == {"unet.spatial", "unet.motion", "unet.epi"}


def test_the_n_view_sampler_refuses_added_conditioning_before_any_draw(both):
    """The N-view sampler does not pass SDXL's added conditioning yet: it
    refuses a ``text_time`` UNet up front, its generator untouched."""
    from cvd_tpu_torch.pipelines.advanced import AdvancedPipeline

    prog, _ = both
    pipe = AdvancedPipeline(prog, F_mat_size=TINY["epi_F_mat_size"], capture=False)
    g = torch.Generator().manual_seed(5)
    before = g.get_state()
    with pytest.raises(ValueError, match="ROADMAP queue 5, item 1"):
        pipe(_ids(4), _ids(2), torch.zeros(2, FRAMES, SIZE, SIZE, 6),
             F_mats=torch.zeros(2, FRAMES, 3, 3), num_inference_steps=2, generator=g)
    assert torch.equal(g.get_state(), before)
    assert pipe.program.stats == {} and pipe.unet_step_ms == []


def test_inference_cli_from_a_backbone_config(tmp_path):
    """``--random-weights`` with a model config whose ``backbone`` names the
    widths (here narrow ones): the bundle is that backbone's, the motion and
    epi heads the yaml's, and a 2-view request samples."""
    import yaml

    from cvd_tpu_torch.cli import inference
    from cvd_tpu_torch.io.tokenizer import HashTokenizer

    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", "sdxl_inference_config.yaml")))
    u = TINY["unet"]
    raw["backbone"]["unet"].update(
        block_out_channels=u["block_out_channels"], transformer_layers_per_block=[1, 2, 1],
        attention_head_dim=u["spatial_heads"], norm_num_groups=u["norm_num_groups"],
        cross_attention_dim=u["cross_attention_dim"],
        addition_time_embed_dim=u["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=u["projection_class_embeddings_input_dim"])
    for enc, key in (("text_encoder", "clip"), ("text_encoder_2", "clip_2")):
        raw["backbone"][enc].update(
            hidden_size=TINY[key]["hidden_size"], num_hidden_layers=TINY[key]["num_layers"],
            num_attention_heads=TINY[key]["num_heads"],
            intermediate_size=TINY[key]["intermediate_size"])
    raw["backbone"]["text_encoder_2"]["projection_dim"] = TINY["clip_2"]["projection_dim"]
    raw["backbone"]["vae"].update(block_out_channels=[32, 32, 64, 64], norm_num_groups=8)
    for kind in ("motion_module_kwargs", "epi_module_kwargs"):
        raw["unet_additional_kwargs"][kind]["num_attention_heads"] = u["attention_heads"]
    raw["pose_encoder_kwargs"]["channels"] = u["block_out_channels"]
    cfg_path = tmp_path / "sdxl_tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps({"captions": ["a quiet street at dusk"],
                                   "negative_prompts": ["blurry"]}))
    args = inference.build_parser().parse_args([
        "--random-weights", "--device", "cpu", "--model_config", str(cfg_path),
        "--image_height", str(SIZE), "--image_width", str(SIZE), "--video_length", "2",
        "--num_inference_steps", "2", "--caption_file", str(prompts), "--use_negative_prompt",
        "--pose_file_0", os.path.join(ROOT, "assets", "pose_files", "example_dolly.txt"),
        "--pose_file_1", os.path.join(ROOT, "assets", "pose_files", "example_arc.txt"),
        "--out_root", str(tmp_path / "out")])
    from cvd_tpu_torch.cli.build import build_modules

    bundle, _ = build_modules(args, torch.device("cpu"), tokenizer=HashTokenizer())
    cfg = bundle.unet.config
    assert cfg.block_out_channels == tuple(u["block_out_channels"])
    assert cfg.attention_heads == u["attention_heads"] and bundle.clip_2 is not None
    records = inference.main(args, tokenizer=HashTokenizer())
    (record,) = records
    assert record["videos"].shape == (2, 2, SIZE, SIZE, 3) and record["videos"].std() > 0
    assert record["program"]["unet_calls"] == 2

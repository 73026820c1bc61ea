"""Reference-format model config yaml -> the port's configs (port of
``cvd_tpu/io/model_config.py``).

The reference drives all model hyperparameters from one OmegaConf yaml
(configs/inference_config.yaml, loaded at inference_epi.py:169-180). This
translator accepts the same schema so existing configs keep working.

A ``backbone`` section names another backbone's widths, as its diffusers
folder's ``config.json`` files state them: ``unet`` (SDXL's
``down_block_types``, ``transformer_layers_per_block``,
``attention_head_dim`` read as head counts, ``use_linear_projection``,
``cross_attention_dim``, the ``text_time`` added embedding),
``text_encoder`` / ``text_encoder_2`` (CLIPTextConfig's fields under
transformers' names) and ``vae`` (``scaling_factor``); the motion and epi
modules' ``num_attention_heads`` (one count for both) are then read too.
Without it the widths and heads are the caller's ``base`` (SD1.5's). ``configs/sdxl_inference_config.yaml``
is CVD on the SDXL backbone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from cvd_tpu_torch.models.clip_text import CLIPTextConfig
from cvd_tpu_torch.models.unet import UNetConfig
from cvd_tpu_torch.models.vae import VAEConfig
from cvd_tpu_torch.schedulers import DDIMScheduler

# transformers' CLIPTextConfig names -> the port's
_CLIP_KEYS = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
              "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
              "intermediate_size": "intermediate_size",
              "max_position_embeddings": "max_position_embeddings",
              "layer_norm_eps": "layer_norm_eps", "hidden_act": "hidden_act",
              "projection_dim": "projection_dim"}
# diffusers' UNet2DConditionModel names the port takes as they are
_UNET_KEYS = ("in_channels", "out_channels", "layers_per_block", "norm_num_groups",
              "cross_attention_dim", "use_linear_projection", "addition_embed_type",
              "addition_time_embed_dim", "projection_class_embeddings_input_dim")


def _as_tuple(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def backbone_widths(section: dict, base: UNetConfig) -> dict:
    """A yaml's ``backbone`` section -> {"unet": ``base`` at its widths,
    "clip", "clip_2" (or None), "vae"}."""
    u = section.get("unet", {})
    ch = tuple(u.get("block_out_channels", base.block_out_channels))
    n = len(ch)
    kinds = u.get("down_block_types", ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"])
    layers = _as_tuple(u.get("transformer_layers_per_block", 1), n)
    depth = tuple(d if kind.startswith("CrossAttn") else 0 for d, kind in zip(layers, kinds))
    unet = dataclasses.replace(
        base, block_out_channels=ch, transformer_layers_per_block=depth,
        mid_transformer_layers=layers[-1],
        spatial_heads=_as_tuple(u.get("attention_head_dim", base.attention_heads), n),
        **{k: tuple(u[k]) if isinstance(u[k], list) else u[k] for k in _UNET_KEYS if k in u})

    def clip(raw):
        return None if raw is None else CLIPTextConfig(
            **{_CLIP_KEYS[k]: v for k, v in raw.items() if k in _CLIP_KEYS})

    return {"unet": unet, "clip": clip(section.get("text_encoder", {})),
            "clip_2": clip(section.get("text_encoder_2")),
            "vae": VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in section.get("vae", {}).items()})}


def load_model_config(path: str, F_mat_size: Optional[int] = None,
                      base: UNetConfig = UNetConfig()):
    """-> (UNetConfig, pose_encoder_kwargs, DDIMScheduler, extra). The yaml
    sets which motion / epi / pose modules the UNet has; its widths are
    ``base``'s (SD1.5's), or its ``backbone`` section's (the motion and epi
    heads included), which also gives
    ``extra["backbone"]``: {"clip", "clip_2", "vae"} configs (None without
    the section). The dtype is not a field of the config: it is the
    modules', set where they are built."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    backbone = None
    u = raw.get("unet_additional_kwargs", {})
    mm = u.get("motion_module_kwargs", {})
    epi = u.get("epi_module_kwargs", {})
    if "backbone" in raw:
        backbone = backbone_widths(raw["backbone"], base)
        base = backbone.pop("unet")
        # a backbone gives every width: the motion and epi modules' heads too
        heads = {kw.get("num_attention_heads", base.attention_heads) for kw in (mm, epi)}
        if len(heads) > 1:
            raise ValueError(f"{path}: the motion and epi modules take one head count "
                             f"(UNetConfig.attention_heads), got {sorted(heads)}")
        base = dataclasses.replace(base, attention_heads=heads.pop())
    ap = raw.get("attention_processor_kwargs", {})

    # temporal attentions named '0', '1', ... get pose conditioning
    names = str(ap.get("temporal_attn_names", "0")).split(",")
    pose_indices = tuple(int(n) for n in names if n.strip().isdigit())

    cfg = dataclasses.replace(
        base,
        use_motion_module=u.get("use_motion_module", True),
        motion_module_resolutions=tuple(u.get("motion_module_resolutions", (1, 2, 4, 8))),
        motion_module_mid_block=u.get("motion_module_mid_block", False),
        motion_num_transformer_blocks=mm.get("num_transformer_block", 1),
        motion_num_attention_blocks=len(mm.get("attention_block_types", ["Temporal_Self"] * 2)),
        motion_pe_max_len=mm.get("temporal_position_encoding_max_len", 32),
        motion_zero_initialize=mm.get("zero_initialize", False),
        use_epi_module=u.get("use_epi_module", True),
        epi_module_resolutions=tuple(u.get("epi_module_resolutions", (1, 2, 4, 8))),
        epi_module_mid_block=u.get("epi_module_mid_block", False),
        epi_num_transformer_blocks=epi.get("num_transformer_block", 1),
        epi_num_attention_blocks=len(epi.get("attention_block_types", ["Epi_Self"] * 2)),
        epi_zero_initialize=epi.get("zero_initialize", True),
        pose_cond_attn_indices=pose_indices if ap.get("add_temporal", True) else (),
        pose_scale=ap.get("scale", 1.0),
        additional_channel=u.get("additional_channel", 0),
    )

    pe = raw.get("pose_encoder_kwargs", {})
    pose_encoder_kwargs = dict(
        downscale_factor=pe.get("downscale_factor", 8),
        nums_rb=pe.get("nums_rb", 2),
        cin=pe.get("cin", 384),
        temporal_attention_nhead=pe.get("temporal_attention_nhead", 8),
        temporal_pe_max_len=pe.get("temporal_position_encoding_max_len", 16),
    )

    ns = raw.get("noise_scheduler_kwargs", {})
    scheduler = DDIMScheduler(
        num_train_timesteps=ns.get("num_train_timesteps", 1000),
        beta_start=ns.get("beta_start", 0.00085),
        beta_end=ns.get("beta_end", 0.012),
        beta_schedule=ns.get("beta_schedule", "linear"),
        steps_offset=ns.get("steps_offset", 1),
        clip_sample=ns.get("clip_sample", False),
    )

    epi_F_size = F_mat_size or epi.get("epi_position_encoding_F_mat_size", 256)
    return cfg, pose_encoder_kwargs, scheduler, {"epi_F_mat_size": epi_F_size, "raw": raw,
                                                 "backbone": backbone}

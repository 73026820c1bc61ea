"""Reference-format model config yaml -> the port's configs (port of
``cvd_tpu/io/model_config.py``).

The reference drives all model hyperparameters from one OmegaConf yaml
(configs/inference_config.yaml, loaded at inference_epi.py:169-180). This
translator accepts the same schema so existing configs keep working.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from cvd_tpu_torch.models.unet import UNetConfig
from cvd_tpu_torch.schedulers import DDIMScheduler


def load_model_config(path: str, F_mat_size: Optional[int] = None,
                      base: UNetConfig = UNetConfig()):
    """-> (UNetConfig, pose_encoder_kwargs, DDIMScheduler, extra). The yaml
    sets which motion / epi / pose modules the UNet has; its widths are
    ``base``'s (SD1.5's). The dtype is not a field of the config: it is the
    modules', set where they are built."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    u = raw.get("unet_additional_kwargs", {})
    mm = u.get("motion_module_kwargs", {})
    epi = u.get("epi_module_kwargs", {})
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
    return cfg, pose_encoder_kwargs, scheduler, {"epi_F_mat_size": epi_F_size, "raw": raw}

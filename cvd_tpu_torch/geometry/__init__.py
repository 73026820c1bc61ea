from cvd_tpu_torch.geometry.cameras import (
    Camera,
    parse_pose_file,
    parse_pose_lines,
    intrinsics_for_crop,
)
from cvd_tpu_torch.geometry.epipolar import (
    cross_product_matrix,
    essential_from_transform,
    fundamental_from_transform,
    relative_transform,
    fundamental_between_views,
    fundamental_between_views_torch,
)
from cvd_tpu_torch.geometry.epipolar_mask import (
    epipolar_lines,
    homography_lines,
    pseudo_lines,
    epipolar_attn_bias_from_lines,
    lines_and_band,
    pixel_grid_coords,
)
from cvd_tpu_torch.geometry.folding import fold_indices, fold_fundamental_mats
from cvd_tpu_torch.geometry.plucker import ray_condition

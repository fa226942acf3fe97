"""Geometry, the 8-direction basis, rotations, von Mises math, small
assignments and the CUDA kernels of the port."""

from .dirs8 import DIRS_8, forward_to_8dir_probs
from .geometry import (
    approx_knn,
    ball_query,
    diff_square_distance,
    exact_full_knn,
    farthest_point_sample,
    grid_pruned_knn,
    group_all,
    index_points,
    knn_indices,
    knn_query,
    random_sample_indices,
    sample_and_group,
    set_knn_impl,
    square_distance,
    topk_of_uniform,
)
from .matching import hungarian_small, matched_mvm_loss
from .rotations import (
    axes_gt_from_rotation,
    forward_to_mu,
    random_so3_matrix,
    random_yaw_matrix,
    rotate_points,
    wrap_angle,
    yaw_matrix,
)
from .von_mises import (
    bessel_ratio,
    kl_von_mises,
    log_i0,
    mixture_von_mises_pdf,
    mvm_density_on_grid,
    von_mises_pdf,
)

__all__ = [
    "DIRS_8",
    "approx_knn",
    "axes_gt_from_rotation",
    "ball_query",
    "bessel_ratio",
    "diff_square_distance",
    "exact_full_knn",
    "farthest_point_sample",
    "forward_to_8dir_probs",
    "forward_to_mu",
    "grid_pruned_knn",
    "group_all",
    "hungarian_small",
    "index_points",
    "kl_von_mises",
    "knn_indices",
    "knn_query",
    "log_i0",
    "matched_mvm_loss",
    "mixture_von_mises_pdf",
    "mvm_density_on_grid",
    "random_sample_indices",
    "random_so3_matrix",
    "random_yaw_matrix",
    "rotate_points",
    "sample_and_group",
    "set_knn_impl",
    "square_distance",
    "topk_of_uniform",
    "von_mises_pdf",
    "wrap_angle",
    "yaw_matrix",
]

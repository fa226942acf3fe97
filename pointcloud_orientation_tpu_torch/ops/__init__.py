"""Geometry, the 8-direction basis, rotations, von Mises math, small
assignments and the CUDA kernels of the port."""

from .dirs8 import DIRS_8, forward_to_8dir_probs
from .geometry import (
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
from .rotations import forward_to_mu, wrap_angle
from .von_mises import bessel_ratio, kl_von_mises, log_i0, von_mises_pdf

__all__ = [
    "DIRS_8",
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
    "random_sample_indices",
    "sample_and_group",
    "set_knn_impl",
    "square_distance",
    "topk_of_uniform",
    "von_mises_pdf",
    "wrap_angle",
]

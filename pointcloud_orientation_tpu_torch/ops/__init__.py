"""Geometry, the 8-direction basis and the CUDA kernels of the port."""

from .dirs8 import DIRS_8, forward_to_8dir_probs
from .geometry import (
    ball_query,
    diff_square_distance,
    exact_full_knn,
    farthest_point_sample,
    group_all,
    index_points,
    knn_query,
    random_sample_indices,
    sample_and_group,
    square_distance,
    topk_of_uniform,
)

__all__ = [
    "DIRS_8",
    "ball_query",
    "diff_square_distance",
    "exact_full_knn",
    "farthest_point_sample",
    "forward_to_8dir_probs",
    "group_all",
    "index_points",
    "knn_query",
    "random_sample_indices",
    "sample_and_group",
    "square_distance",
    "topk_of_uniform",
]

"""The yardstick's arithmetic against hand counts: each kernel's bytes and
operations at one shape, the least time, and the model FLOPs that ``mfu``
counts for both configurations."""

import json
from pathlib import Path

import pytest

from portbench import costs

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_kernel_costs_equal_hand_counts():
    # sa_group B=2 N=100 S=10 K=4 D=3: xyz, feats, cidx read; new_xyz, grouped, idx written
    assert costs.sa_group_cost(2, 100, 10, 4, 3) == (
        4 * (600 + 600 + 20) + 4 * (60 + 2 * 4 * 10 * 6 + 80),
        8 * 2 * 10 * 100 + 5 * 2 * 100 + 5 * 2 * 10 + 3 * 2 * 4 * 10)
    # sa_mlp_max B=1 K=2 S=3, 3->4->5: 6 rows
    assert costs.sa_mlp_cost(1, 2, 3, [3, 4, 5]) == (
        4 * (6 * 3 + (12 + 8) + (20 + 10) + 15), 3 * 6 * 4 + 3 * 6 * 5 + 6 * 5,
        2 * 6 * 3 * 4 + 2 * 6 * 4 * 5)
    assert costs.fps_cost(2, 10, 4) == (4 * (60 + 2 + 8), 10 * 2 * 10 * 3)
    assert costs.ball_cost(2, 3, 10, 4) == (4 * (60 + 18 + 24), 9 * 2 * 3 * 4)
    assert costs.scatter_cost(1, 10, 2, 3, 4) == (4 * (24 + 6 + 40), 24)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert costs.bound_s(3.35e12) == pytest.approx(1.0)
    assert costs.bound_s(1.0, flops=67e12) == pytest.approx(1.0)
    assert costs.bound_s(1.0, f32_products=165e12) == pytest.approx(1.0)
    assert costs.bound_s(3.35e12, flops=2 * 67e12) == pytest.approx(2.0)


def test_mfu_flops_equal_hand_counts():
    # ForwardNet at N=10,000: sa1 128x32 rows, sa2 32x32, sa3 32, FC 1024-512-256-8
    sa = 2 * (4096 * (3 * 64 + 64 * 64 + 64 * 128)
              + 1024 * (131 * 128 + 128 * 128 + 128 * 256)
              + 32 * (259 * 256 + 256 * 512 + 512 * 1024))
    fc = 2 * (1024 * 512 + 512 * 256 + 256 * 8)
    assert costs.forward_flops(config("forwardnet_8dir_kl"), 10_000) == sa + fc == 284_741_632
    # PointNet++ SSG at N=1,024: sa1 512x32 rows, sa2 128x64, group-all 128, FC to 40
    sa = 2 * (16384 * (3 * 64 + 64 * 64 + 64 * 128)
              + 8192 * (131 * 128 + 128 * 128 + 128 * 256)
              + 128 * (259 * 256 + 256 * 512 + 512 * 1024))
    fc = 2 * (1024 * 512 + 512 * 256 + 256 * 40)
    assert costs.forward_flops(config("pointnet2_ssg_cls"), 1024) == sa + fc == 1_675_055_104


@pytest.mark.parametrize("name, train, want", [
    ("forwardnet_8dir_kl", True, {"sa_group": 2, "sa_group_scatter": 1}),
    ("forwardnet_8dir_kl", False, {"sa_group": 2, "sa_mlp_max": 3}),
    ("pointnet2_ssg_cls", True, {"fps": 2, "ball_query": 2}),
    ("pointnet2_ssg_cls", False, {"fps": 2, "ball_query": 2, "sa_mlp_max": 3}),
])
def test_kernel_calls_of_a_forward(name, train, want):
    cfg = config(name)
    calls = costs.kernel_calls(cfg, cfg["num_points"], 4, train)
    assert {k: len(v) for k, v in calls.items()} == want
    assert all(least > 0 for v in calls.values() for _, least in v)


def test_buckets_are_the_predictors():
    assert costs.buckets([1, 2, 3, 8, 9, 64, 65, 300], 256) == [1, 2, 4, 8, 16, 64, 128, 256]

"""The harness's tests: ``python -m pytest portbench/tests -q`` from the
root of the checkout (the card's tests: ``-m cuda`` on a machine with a
card). Cells run here at a tiny size on the CPU, through the port's plain
versions of its kernels."""

import time

import pytest
import torch

from portbench import harness

SEED = 2**31 + 12_345  # more than 32 signed bits hold, as the driver's seeds


def shrink(run: harness.Run, device: str = "cpu") -> harness.Run:
    """A cell's run at a size a test holds: a few clouds of a few hundred
    points (the classifier's 512 centroids need 512), small batches (the
    8-dir model's of 16, so that its followed steps' losses average over
    enough clouds to read as the card's do), a short pool of small
    requests."""
    c, t = run.config, run.traffic
    if c["task"] == "classification":
        c["data"]["classes"] = [[n, 1] for n, _ in c["data"]["classes"]]
        c["data"]["source_points"], c["num_points"], c["batch_size"] = 768, 512, 4
    else:
        c["data"]["classes"] = [[n, 8] for n, _ in c["data"]["classes"]]
        c["data"]["source_points"] = c["num_points"] = 128
        c["batch_size"] = 16
    if t["entry"] == "serve":
        t.update(clouds=[2, 8], max_batch=8, pool=6, check=3,
                 points=[c["num_points"] // 2, c["num_points"]])
    else:
        t["epochs_per_call"] = min(t["epochs_per_call"], 2)
    run.device = device
    return run


@pytest.fixture
def tiny():
    """``tiny(cell, seed=SEED, trace=False)``: the cell's run, shrunk."""
    torch.set_num_threads(2)

    def make(cell: str, seed: int = SEED, trace: bool = False, device: str = "cpu"):
        return shrink(harness.load_run(cell, seed, 0.2, trace, time.perf_counter()), device)

    return make

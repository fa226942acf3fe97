"""The control on the card: the plain reference computed in TF32, put in
the program's place, comes out not correct against each cell's limits.
The cells' widths and points, fewer clouds and requests; on the card only
(the CPU has no TF32). ``calibrate.py`` reads the same at the cells' full
size."""

import time

import pytest

from portbench import harness
from portbench.entries import fit, serve

from .conftest import SEED


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return "cuda"


def smaller(cell: str, device: str) -> harness.Run:
    run = harness.load_run(cell, SEED, 1.0, False, time.perf_counter())
    run.device = device
    c, t = run.config, run.traffic
    c["data"]["classes"] = [[n, max(8, k // 16)] for n, k in c["data"]["classes"]]
    if t["entry"] == "serve":
        t.update(pool=8, check=3)
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fwd8_train", "cls_train", "fwd8_serve_tta8", "cls_serve"])
def test_tf32_control_is_not_correct(card, cell):
    run = smaller(cell, card)
    entry = fit if run.traffic["entry"] == "fit" else serve
    readings = entry.control(run)["tf32"]
    assert not harness.correct(harness.judge(readings, run.limits)), readings

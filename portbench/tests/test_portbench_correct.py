"""``correct`` at a tiny size on the CPU: each cell's run, past the look
for a chip, against the plain reference with the cell's own limits comes
out true; with the timed path broken underneath it comes out false, once
for each fault the cell can have: a step that returns its state unchanged
(from the first call, or only in the calls chained after it), half of each
batch left out of the loss's mean, running statistics left unchanged or
moved at another momentum (training), an answer altered where it is
produced (serving). One chip: no exchange to leave out."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from portbench import run as bench_run
from portbench.entries import fit, serve
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.models import layers
from pointcloud_orientation_tpu_torch.train import Trainer


def result(run):
    entry = fit if run.traffic["entry"] == "fit" else serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_run.report(run, entry) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["fwd8_train", "cls_train", "fwd8_serve_tta8", "cls_serve"])
def test_sound_run_is_correct(tiny, cell):
    res = result(tiny(cell))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


def unchanged_state(monkeypatch):
    """Adam keeps its moments but leaves the parameters as they were."""
    step = torch.optim.Adam.step

    def kept(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        step(self, closure)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)

    monkeypatch.setattr(torch.optim.Adam, "step", kept)


def unchanged_state_chained(monkeypatch):
    """As :func:`unchanged_state`, from the second fit call on: the first
    call, which set-up's comparison follows, stays sound."""
    step, fit = torch.optim.Adam.step, Trainer.fit

    def chained(self, *args, start_epoch=1, **kwargs):
        self.optimizer.frozen = start_epoch > 1
        return fit(self, *args, start_epoch=start_epoch, **kwargs)

    def kept(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        step(self, closure)
        if getattr(self, "frozen", False):
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)

    monkeypatch.setattr(Trainer, "fit", chained)
    monkeypatch.setattr(torch.optim.Adam, "step", kept)


def frozen_stats(monkeypatch):
    """BatchNorm's running statistics never updated."""
    monkeypatch.setattr(layers, "BN_MOMENTUM", 1.0)


def other_momentum(monkeypatch):
    """BatchNorm's running statistics moved at momentum 0.99, not 0.9."""
    monkeypatch.setattr(layers, "BN_MOMENTUM", 0.99)


def half_batch(monkeypatch):
    """The loss's mean over the first half of each batch only."""
    metrics = Trainer._metrics

    def half(self, outputs, batch, per, valid):
        keep = torch.ones_like(valid)
        keep[valid.shape[0] // 2:] = 0.0
        return metrics(self, outputs, batch, per, valid * keep)

    monkeypatch.setattr(Trainer, "_metrics", half)


def altered_answer(monkeypatch):
    """The first cloud's answer rolled by one direction or class."""
    call = OrientationPredictor.__call__

    def altered(self, clouds):
        out = np.array(call(self, clouds))
        out[0] = np.roll(out[0], 1)
        return out

    monkeypatch.setattr(OrientationPredictor, "__call__", altered)


@pytest.mark.parametrize("cell, fault", [
    ("fwd8_train", unchanged_state), ("fwd8_train", unchanged_state_chained),
    ("fwd8_train", half_batch), ("fwd8_train", frozen_stats), ("fwd8_train", other_momentum),
    ("cls_train", unchanged_state), ("cls_train", unchanged_state_chained),
    ("cls_train", half_batch), ("cls_train", frozen_stats), ("cls_train", other_momentum),
    ("fwd8_serve_tta8", altered_answer), ("cls_serve", altered_answer),
])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = result(tiny(cell))
    assert not res["correct"], res["checks"]

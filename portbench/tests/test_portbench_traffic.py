"""Inputs from the seed: the same seed gives the same clouds, weights and
request pool; every seed gives the pool the same sizes, in its own order."""

import numpy as np
import pytest
import torch

from portbench import harness, synth, weights
from portbench.entries import fit, serve

from .conftest import SEED


def test_seed_for_takes_large_seeds_and_differs_by_purpose(tiny):
    run = tiny("fwd8_train", seed=10**12 + 7)
    seeds = {p: run.seed_for(p) for p in ("weights", "clouds", "trainer", "pool")}
    assert len(set(seeds.values())) == 4
    assert all(0 <= s < 2**31 for s in seeds.values())
    assert tiny("fwd8_train", seed=10**12 + 7).seed_for("weights") == seeds["weights"]


@pytest.mark.parametrize("cell", ["fwd8_train", "cls_train"])
def test_training_inputs_repeat_from_the_seed(tiny, cell):
    a, b = fit.make_inputs(tiny(cell)), fit.make_inputs(tiny(cell))
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    assert a[2] == b[2]
    assert all(torch.equal(a[3][k], b[3][k]) for k in a[3])
    other = fit.make_inputs(tiny(cell, seed=SEED + 1))
    assert not torch.equal(a[0], other[0])
    pts = a[0]
    assert pts.abs().amax(dim=(1, 2)).max() <= 1.0 + 0.05  # unit max-norm, then noise
    counts = torch.bincount(a[1]).tolist()
    assert counts == [n for _, n in tiny(cell).config["data"]["classes"]]


@pytest.mark.parametrize("cell", ["fwd8_serve_tta8", "cls_serve"])
def test_request_pool_repeats_from_the_seed(tiny, cell):
    (wa, pa), (wb, pb) = serve.make_inputs(tiny(cell)), serve.make_inputs(tiny(cell))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert len(pa) == len(pb) and all(np.array_equal(x, y) for x, y in zip(pa, pb))
    _, pc = serve.make_inputs(tiny(cell, seed=SEED + 1))
    assert sorted(r.shape[0] for r in pa) == sorted(r.shape[0] for r in pc)
    assert sorted(r.shape[1] for r in pa) == sorted(r.shape[1] for r in pc)
    assert any(not np.array_equal(x, y) for x, y in zip(pa, pc))


def test_spread_is_the_same_sizes_for_every_seed():
    sizes = synth.spread(8, 64, 100, True)
    assert sizes.min() >= 8 and sizes.max() <= 64
    assert np.all(np.diff(sizes) >= 0)
    assert synth.spread(1024, 2048, 10, False).tolist() == [
        int(1024 + (i + 0.5) / 10 * 1025) for i in range(10)]


def test_weights_round_trip_through_the_flax_layout(tiny):
    run = tiny("cls_serve")
    W = weights.make_weights(run.config, 3, torch.device("cpu"), serving=True)
    back = weights.from_flax(run.config, weights.to_flax(run.config, W), torch.device("cpu"))
    assert sorted(back) == sorted(W)
    assert all(torch.equal(back[k], W[k]) for k in W)
    assert harness.forbidden_modules() == []


def test_arrivals_are_the_same_gaps_for_every_seed():
    a, b = synth.arrivals(80.0, 10.0, 1), synth.arrivals(80.0, 10.0, 2)
    assert len(a) == len(b) == 801 and np.all(np.diff(a) > 0)
    assert np.allclose(np.sort(np.diff(a, prepend=0.0)), np.sort(np.diff(b, prepend=0.0)))
    assert not np.allclose(a, b)
    assert np.array_equal(a, synth.arrivals(80.0, 10.0, 1))
    assert abs(a[-1] - 801 / 80.0) < 0.5  # the mean gap is the rate's

"""The port's HTTP front end (``demos/serve_http_torch.py``) on the CPU: the
stdlib server in-process on an ephemeral port, its wire contract as
``tests/test_serve_http.py`` holds the JAX server's (``/healthz``,
``/predict`` returning unit forward vectors, a 400 on a bad shape), and
the int8 artifact and TTA flags."""

import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.utils import random_flax_variables
from pointcloud_orientation_tpu_torch.utils.quantize import save_quantized_checkpoint

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos",
                     "serve_http_torch.py")
_spec = importlib.util.spec_from_file_location("serve_http_torch", _PATH)
serve_http_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(serve_http_torch)

N = 160


def _start(argv):
    args = serve_http_torch.parse_args(argv + ["--device", "cpu", "--num-points", str(N),
                                               "--max-batch", "8"])
    predictor = serve_http_torch.build_predictor(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve_http_torch.make_handler(predictor))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, predictor, f"http://127.0.0.1:{srv.server_port}"


@pytest.fixture(scope="module")
def server():
    srv, predictor, url = _start([])
    yield url, predictor
    srv.shutdown()
    srv.server_close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert r.status == 200
    assert body == {"status": "ok", "model": "pointnet_pp_8dir", "num_points": N}


def test_predict_returns_unit_forward_vectors(server):
    url, predictor = server
    clouds = np.random.RandomState(0).randn(3, N, 3).astype(np.float32)
    status, body = _post(url + "/predict", {"clouds": clouds.tolist()})
    assert status == 200, body
    fwd = np.asarray(body["forward_vectors"], np.float32)
    assert fwd.shape == (3, 3)
    np.testing.assert_allclose(np.linalg.norm(fwd, axis=-1), 1.0, atol=1e-5)
    assert body["batch"] == 3 and body["latency_ms"] > 0
    assert np.isfinite(predictor(clouds)).all()


@pytest.mark.parametrize("clouds", [[[1.0, 2.0, 3.0]], [[[1.0, 2.0]]], "nonsense"],
                         ids=["2-d", "2-channels", "not-numbers"])
def test_predict_rejects_bad_shape(server, clouds):
    url, _ = server
    status, body = _post(url + "/predict", {"clouds": clouds})
    assert status == 400 and body["error"]
    if clouds != "nonsense":
        assert "B, N, 3" in body["error"]


def test_unknown_paths_are_404(server):
    url, _ = server
    assert _post(url + "/nowhere", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nowhere", timeout=30)
    assert e.value.code == 404


def test_quantized_npz_and_tta_flags(tmp_path):
    """``--quantized-npz`` serves the int8 artifact as
    ``from_quantized_checkpoint`` does, and ``--tta-views`` votes: the
    server's vectors are the predictor's own on the same request."""
    v = random_flax_variables(0)
    path = str(tmp_path / "int8.npz")
    save_quantized_checkpoint(path, v["params"], v["batch_stats"])
    clouds = np.random.RandomState(1).randn(2, N, 3).astype(np.float32)
    srv, predictor, url = _start(["--quantized-npz", path, "--tta-views", "4"])
    try:
        status, body = _post(url + "/predict", {"clouds": clouds.tolist()})
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 200, body
    assert predictor.tta_views == 4 and predictor._quantized
    direct = OrientationPredictor.from_quantized_checkpoint(
        path, "pointnet_pp_8dir", num_points=N, max_batch=8, tta_views=4, device="cpu")
    # the same seed: the first request samples the same centroids
    np.testing.assert_allclose(body["forward_vectors"], direct.forward_vectors(clouds),
                               rtol=1e-6, atol=1e-6)


def test_help_names_the_flags_and_the_orbax_refusal(capsys, tmp_path):
    """The help names every flag, ``--orbax`` among them (once a refusal),
    and ``--orbax`` serves a JAX-written Orbax checkpoint as the
    predictor built from its weights."""
    with pytest.raises(SystemExit):
        serve_http_torch.parse_args(["--help"])
    out = capsys.readouterr().out
    for flag in ("--model", "--torch-ckpt", "--quantized-npz", "--quantize", "--tta-views",
                 "--device", "--orbax"):
        assert flag in out
    assert serve_http_torch.parse_args([]).device == "cuda"
    import orbax.checkpoint as ocp

    v = random_flax_variables(2)
    path = str(tmp_path / "step_0")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, {"params": v["params"], "batch_stats": v["batch_stats"],
                          "step": np.asarray(0, np.int32)})
    clouds = np.random.RandomState(2).randn(2, N, 3).astype(np.float32)
    srv, predictor, url = _start(["--orbax", path])
    try:
        status, body = _post(url + "/predict", {"clouds": clouds.tolist()})
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 200, body
    direct = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                  num_points=N, max_batch=8, device="cpu")
    np.testing.assert_allclose(body["forward_vectors"], direct.forward_vectors(clouds),
                               rtol=1e-6, atol=1e-6)

"""Minimal HTTP serving front end for the port's ``OrientationPredictor``
(the port of ``demos/serve_http.py``): a standard-library HTTP server, no
framework.

    # random weights from a seed (or --torch-ckpt / --quantized-npz for real ones)
    python demos/serve_http_torch.py --port 8321 &

    curl -s -X POST localhost:8321/predict \\
        -H 'Content-Type: application/json' \\
        -d '{"clouds": [[[0.1, 0.2, 0.3], ...N points...]]}'
    # -> {"forward_vectors": [[x, y, z], ...], "batch": 1, "latency_ms": ...}

POST /predict takes ``{"clouds": (B, N, 3) nested lists}`` and returns the
decoded unit forward vectors; GET /healthz reports readiness. Requests of
any batch and point count are padded to the predictor's buckets.
``--orbax`` serves an Orbax checkpoint (a ``step_<N>`` directory of the JAX
package's ``Trainer.save_checkpoint``, read without orbax), ``--torch-ckpt``
a reference ``.pth``, ``--quantized-npz`` an int8 ``.npz`` artifact
(``utils/quantize.py`` of either package); ``--quantize int8`` quantizes
the weights it is given, ``--tta-views`` votes over yaw views.
``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_predictor(args):
    from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
    from pointcloud_orientation_tpu_torch.utils import random_flax_variables

    kw = dict(num_points=args.num_points, max_batch=args.max_batch, device=args.device,
              tta_views=args.tta_views)
    if args.quantize:
        kw["quantize"] = args.quantize
    if args.orbax:
        return OrientationPredictor.from_orbax_checkpoint(args.orbax, args.model, **kw)
    if args.quantized_npz:
        return OrientationPredictor.from_quantized_checkpoint(args.quantized_npz, args.model, **kw)
    if args.torch_ckpt:
        return OrientationPredictor.from_torch_checkpoint(args.torch_ckpt, args.model, **kw)
    v = random_flax_variables(0, args.model)  # demo and latency mode
    return OrientationPredictor(args.model, v["params"], v.get("batch_stats"), **kw)


def make_handler(predictor):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": predictor.model_name,
                                 "num_points": predictor.num_points})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                return self._send(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                clouds = np.asarray(req["clouds"], np.float32)
                if clouds.ndim != 3 or clouds.shape[-1] != 3:
                    raise ValueError(f"clouds must be (B, N, 3), got {clouds.shape}")
                t0 = time.perf_counter()
                fwd = predictor.forward_vectors(clouds)
                ms = (time.perf_counter() - t0) * 1e3
                self._send(200, {"forward_vectors": fwd.tolist(), "batch": int(clouds.shape[0]),
                                 "latency_ms": round(ms, 3)})
            except Exception as e:  # report, do not kill the server
                self._send(400, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="pointnet_pp_8dir")
    ap.add_argument("--orbax", default=None,
                    help="an Orbax checkpoint of the JAX package (a step_N directory)")
    ap.add_argument("--torch-ckpt", default=None, help="a reference-layout .pth")
    ap.add_argument("--quantized-npz", default=None,
                    help="an int8 .npz artifact (save_quantized_checkpoint)")
    ap.add_argument("--num-points", type=int, default=1024)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--quantize", default=None, choices=(None, "int8"))
    ap.add_argument("--tta-views", type=int, default=1, help="yaw-voting views (8-dir: 2, 4, 8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    predictor = build_predictor(args)
    predictor(np.zeros((1, args.num_points, 3), np.float32))  # build the kernels first
    server = ThreadingHTTPServer((args.host, args.port), make_handler(predictor))
    print(f"serving {args.model} on http://{args.host}:{server.server_port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()

"""Rewrite ``tests/data/modelnet_h5``: a small ModelNet40 HDF5 archive that
h5py writes, in the layout of PointNet's ``save_h5``.

    JAX_PLATFORMS=cpu python tests/torch_make_h5_fixture.py

``ply_data_train0.h5`` (7 clouds) and ``ply_data_test0.h5`` (3 clouds) of
2,048 points, each with ``data`` (float32, gzip 4), ``label`` (uint8 ``(S,
1)``, gzip 1), ``normal`` (float32, gzip 4) and ``faceId`` (int32, gzip 4),
chunked as h5py picks; the arrays are ``benchmarks/modelnet_h5.py``'s at
seed 28. ``shape_names.txt`` lists the 40 classes, and ``expected.json``
each dataset's shape, dtype and the SHA-256 of its bytes (C order), which
``tests/test_torch_h5format.py`` and ``chip_smoke.py``'s ``hdf5`` phase
hold the port's reader to.
"""

import hashlib
import json
import os
import sys

import h5py
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pointcloud_orientation_tpu_torch.benchmarks.modelnet_h5 import (  # noqa: E402
    MODELNET40,
    modelnet_files,
)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "modelnet_h5")
SEED = 28
LEVELS = {"data": 4, "label": 1, "normal": 4, "faceId": 4}


def digest(arr: np.ndarray) -> dict:
    return {"shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()}


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    expected = {}
    for fname, arrays in modelnet_files(SEED, train=(7,), test=(3,)).items():
        with h5py.File(os.path.join(OUT, fname), "w") as f:
            for name, arr in arrays.items():
                f.create_dataset(name, data=arr, compression="gzip",
                                 compression_opts=LEVELS[name])
        expected[fname] = {name: digest(arr) for name, arr in arrays.items()}
    with open(os.path.join(OUT, "shape_names.txt"), "w") as f:
        f.write("\n".join(MODELNET40) + "\n")
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()

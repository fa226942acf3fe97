"""A ModelNet40-shaped HDF5 archive written from a seed, without h5py.

    python -m pointcloud_orientation_tpu_torch.benchmarks.modelnet_h5 OUT_DIR [--seed 0]
        [--train 2048,2048,2048,2048,1651] [--test 2048,420] [--num-points 2048]

A test and measurement tool, not an API of the data package: it makes the
archive that ``--data hdf5:DIR`` reads where there is neither the archive
nor h5py to write one. The files have the layout of PointNet's ``save_h5``
(``ply_data_train<i>.h5``, ``ply_data_test<i>.h5`` and ``shape_names.txt``
with the 40 ModelNet40 classes in the archive's order), each with four
datasets in h5py's earliest file format (superblock version 0, version-1
object headers, a symbol-table root group, chunked storage indexed by a
version-1 B-tree, chunk shapes as h5py's ``guess_chunk`` picks them):

- ``data``: ``(S, P, 3)`` float32, gzip level 4 (chunks of (128, 128, 1)
  in a full file of 2,048 clouds of 2,048 points);
- ``label``: ``(S, 1)`` uint8, gzip level 1;
- ``normal``: ``(S, P, 3)`` float32, gzip level 4: each point's box-face
  normal, the signed axis of its largest coordinate;
- ``faceId``: ``(S, P)`` int32 below 1,000, gzip level 4.

By default 12,311 clouds of 2,048 points: five train files of 2,048, 2,048,
2,048, 2,048 and 1,651 clouds (9,843) and two test files of 2,048 and 420
(2,468). The clouds are the port's ``synthetic_modelnet`` shapes over the 40
class names (an orientation is learnable), drawn from a pool of
``ceil(S / 40)`` clouds a class in an order and with labels that the seed
gives; the face ids come from the seed too. Chunks are compressed
on a pool of threads (``zlib`` releases the GIL).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.h5format import SIGNATURE
from ..data.hdf5 import synthetic_modelnet

MODELNET40 = (
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl", "car", "chair",
    "cone", "cup", "curtain", "desk", "door", "dresser", "flower_pot", "glass_box", "guitar",
    "keyboard", "lamp", "laptop", "mantel", "monitor", "night_stand", "person", "piano",
    "plant", "radio", "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
)
TRAIN_FILES = (2048, 2048, 2048, 2048, 1651)
TEST_FILES = (2048, 420)
NUM_POINTS = 2048
FACES = 1000  # face ids drawn below this
LEVELS = {"data": 4, "label": 1, "normal": 4, "faceId": 4}  # gzip levels, as PointNet writes them

_O = 8  # sizes of offsets and lengths
_UNDEF = (1 << 64) - 1
_GROUP_LEAF_K, _GROUP_INTERNAL_K, _CHUNK_K = 4, 16, 32  # HDF5's defaults
_HEADER_MIN = 256  # h5py's datasets' object headers: messages padded by a NIL message

# h5py's guess_chunk constants
_CHUNK_BASE, _CHUNK_MIN, _CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def guess_chunk(shape: Sequence[int], itemsize: int) -> Tuple[int, ...]:
    """The chunk shape h5py picks for a dataset of ``shape`` created with
    compression and no ``chunks``: halve the axes in turn until the chunk is
    under a target size that grows with the dataset's."""
    chunks = np.array([s if s else 1024 for s in shape], dtype=np.float64)
    dset_size = np.prod(chunks) * itemsize
    target = _CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, _CHUNK_MIN), _CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * itemsize
        if ((chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5)
                and chunk_bytes < _CHUNK_MAX):
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = math.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(c) for c in chunks)


def _pad8(raw: bytes) -> bytes:
    return raw + b"\0" * (-len(raw) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _datatype(dt: np.dtype) -> bytes:
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return struct.pack("<B3BI2H", 0x10, bits, 0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        prec, eloc, esize, mloc, msize, bias = {2: (16, 10, 5, 0, 10, 15),
                                                4: (32, 23, 8, 0, 23, 127),
                                                8: (64, 52, 11, 0, 52, 1023)}[dt.itemsize]
        return struct.pack("<B3BI2H4BI", 0x11, order | 0x20, 8 * dt.itemsize - 1, 0,
                           dt.itemsize, 0, prec, eloc, esize, mloc, msize, bias)
    raise ValueError(f"dtype {dt}: only integers and IEEE floats are written")


def _chunk_btree(keys: List[bytes], addrs: List[int], right: bytes, alloc) -> int:
    """Version-1 B-tree nodes of type 1 over the chunks (keys in chunk
    order), built from the leaves up; returns the root's address. Every
    node is allocated at its full size (2K entries)."""
    key_size = len(right)
    node_size = 8 + 2 * _O + (2 * _CHUNK_K + 1) * key_size + 2 * _CHUNK_K * _O
    level = 0
    while True:
        groups = [range(i, min(i + 2 * _CHUNK_K, len(keys)))
                  for i in range(0, len(keys), 2 * _CHUNK_K)]
        nodes, node_keys = [], []
        for gi, group in enumerate(groups):
            last = keys[groups[gi + 1][0]] if gi + 1 < len(groups) else right
            body = b"".join(keys[i] + struct.pack("<Q", addrs[i]) for i in group) + last
            raw = (b"TREE" + struct.pack("<BBH", 1, level, len(group))
                   + struct.pack("<QQ", _UNDEF, _UNDEF) + body)
            nodes.append(alloc(raw.ljust(node_size, b"\0")))
            node_keys.append(keys[group[0]])
        if len(nodes) == 1:
            return nodes[0]
        keys, addrs, level = node_keys, nodes, level + 1


class _Writer:
    """Appends blocks to a file image and hands out their addresses; a
    block reserved early is filled in once what it points to is placed."""

    def __init__(self):
        self.parts: List[bytes] = []
        self.at: Dict[int, int] = {}  # address -> index in parts
        self.size = 0

    def alloc(self, raw: bytes) -> int:
        addr = self.size
        self.at[addr] = len(self.parts)
        self.parts.append(raw)
        self.size += len(raw)
        return addr

    def reserve(self, n: int) -> int:
        return self.alloc(b"\0" * n)

    def patch(self, addr: int, raw: bytes) -> None:
        i = self.at[addr]
        if len(self.parts[i]) != len(raw):
            raise ValueError(f"a block of {len(raw)} bytes for {len(self.parts[i])} reserved")
        self.parts[i] = raw


def _compress_chunks(arr: np.ndarray, chunks: Tuple[int, ...], level: int,
                     pool: Optional[ThreadPoolExecutor]):
    """Every chunk of ``arr`` in C order: (offsets, deflated bytes), edge
    chunks padded with zeros to the full chunk shape."""
    offsets = list(itertools.product(*(range(0, s, c) for s, c in zip(arr.shape, chunks))))

    def one(off):
        block = arr[tuple(slice(o, o + c) for o, c in zip(off, chunks))]
        if block.shape != chunks:
            full = np.zeros(chunks, arr.dtype)
            full[tuple(slice(0, n) for n in block.shape)] = block
            block = full
        return off, zlib.compress(np.ascontiguousarray(block).tobytes(), level)

    return list(pool.map(one, offsets) if pool else map(one, offsets))


def write_h5(path: str, datasets: Dict[str, Tuple[np.ndarray, int]]) -> int:
    """Write ``{name: (array, gzip level)}`` as one HDF5 file in h5py's
    earliest format, each dataset chunked as h5py's ``guess_chunk`` picks
    and deflated at its level; returns the file's bytes. Up to 8 datasets
    (one symbol-table node), names in the root group, arrays of at least one
    dimension and element, integer or IEEE float."""
    if not 0 < len(datasets) <= 2 * _GROUP_LEAF_K:
        raise ValueError(f"{len(datasets)} datasets: 1 to {2 * _GROUP_LEAF_K} are written")
    names = sorted(datasets, key=lambda n: n.encode())
    w = _Writer()
    w.reserve(56 + 40)  # superblock and the root's symbol-table entry, patched last
    root_header = w.reserve(16 + 8 + 2 * _O)
    btree = w.reserve(8 + 2 * _O + (2 * _GROUP_INTERNAL_K + 1) * _O + 2 * _GROUP_INTERNAL_K * _O)
    segment, offsets = bytearray(8), {}  # the empty name at offset 0
    for name in names:
        offsets[name] = len(segment)
        segment += _pad8(name.encode() + b"\0")
    used = len(segment)
    segment += struct.pack("<QQ", 1, 16)  # one free block of 16 bytes, the end of the list
    heap = w.reserve(32)
    heap_data = w.alloc(bytes(segment))
    w.patch(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(segment), used, heap_data))

    workers = min(8, os.cpu_count() or 1)
    headers = {}
    with ThreadPoolExecutor(workers) if workers > 1 else contextlib.nullcontext() as pool:
        for name in names:
            arr, level = datasets[name]
            arr = np.ascontiguousarray(arr)
            if arr.ndim == 0 or arr.size == 0:
                raise ValueError(f"{name}: shape {arr.shape}; a chunked dataset needs elements")
            chunks = guess_chunk(arr.shape, arr.dtype.itemsize)
            rank = arr.ndim
            keys, addrs = [], []
            for off, raw in _compress_chunks(arr, chunks, level, pool):
                keys.append(struct.pack(f"<II{rank + 1}Q", len(raw), 0, *off, 0))
                addrs.append(w.alloc(raw))
            last = [o + c for o, c in zip(off, chunks)]
            right = struct.pack(f"<II{rank + 1}Q", 0, 0, *last, arr.dtype.itemsize)
            root = _chunk_btree(keys, addrs, right, w.alloc)
            dims = struct.pack(f"<{rank}Q", *arr.shape)
            msgs = [
                _message(0x1, struct.pack("<BBB5x", 1, rank, 1) + dims + dims),
                _message(0x3, _datatype(arr.dtype), flags=1),
                _message(0x5, struct.pack("<BBBBI", 2, 3, 2, 1, 0), flags=1),
                _message(0xB, struct.pack("<BB6x", 1, 1)
                         + struct.pack("<HHHH", 1, 8, 1, 1) + b"deflate\0"
                         + struct.pack("<II", level, 0), flags=1),
                _message(0x8, struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, root,
                                          *chunks, arr.dtype.itemsize)),
            ]
            size = sum(map(len, msgs))
            if size + 8 <= _HEADER_MIN:
                msgs.append(_message(0x0, b"\0" * (_HEADER_MIN - size - 8)))
            body = b"".join(msgs)
            headers[name] = w.alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body))
                                    + body)

    entries = b"".join(struct.pack("<QQII16x", offsets[n], headers[n], 0, 0) for n in names)
    snod = w.alloc((b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries)
                   .ljust(8 + 2 * _GROUP_LEAF_K * 40, b"\0"))
    w.patch(btree, (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
                    + struct.pack("<QQQ", 0, snod, offsets[names[-1]]))
            .ljust(8 + 2 * _O + (2 * _GROUP_INTERNAL_K + 1) * _O + 2 * _GROUP_INTERNAL_K * _O,
                   b"\0"))
    w.patch(root_header, struct.pack("<BBHII4x", 1, 0, 1, 1, 8 + 2 * _O)
            + _message(0x11, struct.pack("<QQ", btree, heap)))
    superblock = (SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, _O, _O, 0, _GROUP_LEAF_K,
                                          _GROUP_INTERNAL_K, 0)
                  + struct.pack("<QQQQ", 0, _UNDEF, w.size, _UNDEF)
                  + struct.pack("<QQII", 0, root_header, 1, 0) + struct.pack("<QQ", btree, heap))
    w.patch(0, superblock)
    with open(path, "wb") as f:
        for part in w.parts:
            f.write(part)
    return w.size


def modelnet_files(seed: int = 0, train: Sequence[int] = TRAIN_FILES,
                   test: Sequence[int] = TEST_FILES,
                   num_points: int = NUM_POINTS) -> Dict[str, Dict[str, np.ndarray]]:
    """The archive's contents: ``{file name: {"data", "label", "normal",
    "faceId"}}`` in the order of ``train`` then ``test``."""
    sizes = [(f"ply_data_train{i}.h5", n) for i, n in enumerate(train)]
    sizes += [(f"ply_data_test{i}.h5", n) for i, n in enumerate(test)]
    total = sum(n for _, n in sizes)
    pool, pool_labels, _ = synthetic_modelnet(
        seed=seed, class_names=list(MODELNET40),
        samples_per_class=-(-total // len(MODELNET40)), num_points=num_points)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pool))[:total]
    files, at = {}, 0
    for fname, n in sizes:
        rows = order[at:at + n]
        at += n
        data = pool[rows]
        # the box face a point lies on: the axis of its largest coordinate
        axis = np.abs(data).argmax(-1)[..., None]
        normal = np.where(np.arange(3) == axis, np.sign(data), 0).astype(np.float32)
        files[fname] = {
            "data": data,
            "label": pool_labels[rows].astype(np.uint8)[:, None],
            "normal": normal,
            "faceId": rng.integers(0, FACES, size=(n, num_points), dtype=np.int32),
        }
    return files


def write_modelnet_h5(out_dir: str, seed: int = 0, train: Sequence[int] = TRAIN_FILES,
                      test: Sequence[int] = TEST_FILES, num_points: int = NUM_POINTS
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """Write the archive (:func:`modelnet_files`) and ``shape_names.txt`` into
    ``out_dir``; returns what was written, file by file."""
    os.makedirs(out_dir, exist_ok=True)
    files = modelnet_files(seed, train, test, num_points)
    for fname, arrays in files.items():
        write_h5(os.path.join(out_dir, fname),
                 {k: (v, LEVELS[k]) for k, v in arrays.items()})
    with open(os.path.join(out_dir, "shape_names.txt"), "w") as f:
        f.write("\n".join(MODELNET40) + "\n")
    return files


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", default=",".join(map(str, TRAIN_FILES)))
    ap.add_argument("--test", default=",".join(map(str, TEST_FILES)))
    ap.add_argument("--num-points", type=int, default=NUM_POINTS, dest="num_points")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    files = write_modelnet_h5(args.out_dir, args.seed, [int(n) for n in args.train.split(",")],
                              [int(n) for n in args.test.split(",")], args.num_points)
    sizes = {f: os.path.getsize(os.path.join(args.out_dir, f)) for f in files}
    print(json.dumps({"files": sizes, "clouds": sum(len(a["label"]) for a in files.values()),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()

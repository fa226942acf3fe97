"""The port's HDF5 reader (``data/h5format.py``, no h5py) against h5py on
files that h5py writes here: every layout case bit for bit with its dtype
and shape, a hypothesis sweep over shapes, chunk shapes, dtypes and
filters, the refusals (each a ``ValueError`` naming the feature); the
committed fixture ``tests/data/modelnet_h5`` against its ``expected.json``;
the fixture writer ``benchmarks/modelnet_h5.py`` read back by h5py and
loaded by the JAX package's ``load_modelnet_hdf5`` equal to the port's."""

import hashlib
import json
import os

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pointcloud_orientation_tpu.data import hdf5 as jax_hdf5
from pointcloud_orientation_tpu_torch.benchmarks import modelnet_h5 as MH
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.data import h5format as H
from pointcloud_orientation_tpu_torch.data.hdf5 import load_modelnet_hdf5

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "modelnet_h5")


def _assert_reads_as_h5py(path):
    """Every dataset of ``path``: ``list_datasets`` and ``read_dataset``
    against h5py, bit for bit, dtype and shape."""
    listed = H.list_datasets(path)
    with h5py.File(path, "r") as f:
        names = []
        f.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        assert sorted(listed) == sorted(names)
        for name in names:
            want = f[name][()]
            got = H.read_dataset(path, name)
            if f[name].shape is None:  # a null dataspace
                assert got is None and listed[name][0] is None
                continue
            want = np.asarray(want)
            native = want.dtype.newbyteorder("=")
            assert got.dtype == native and listed[name] == (want.shape, native), name
            assert got.shape == want.shape, name
            assert got.tobytes() == want.astype(native).tobytes(), name
    return listed


def _contiguous(f, rng):
    f["data"] = rng.normal(size=(5, 64, 3)).astype(np.float32)
    f["label"] = rng.integers(0, 3, size=(5, 1)).astype(np.uint8)


def _pointnet(f, rng):
    f.create_dataset("data", data=rng.normal(size=(300, 2048, 3)).astype(np.float32),
                     compression="gzip", compression_opts=4)
    f.create_dataset("label", data=rng.integers(0, 40, size=(300, 1)).astype(np.uint8),
                     compression="gzip", compression_opts=1)
    assert f["data"].chunks == (38, 256, 1) and f["label"].compression_opts == 1


def _shuffle_gzip(f, rng):
    f.create_dataset("x", data=rng.normal(size=(200, 33)).astype(np.float32),
                     compression="gzip", shuffle=True, chunks=(64, 16))
    f.create_dataset("i", data=rng.integers(-9, 9, size=(1000,), dtype=np.int64),
                     shuffle=True, compression="gzip", chunks=(300,))


def _fletcher32(f, rng):
    f.create_dataset("x", data=rng.normal(size=(100, 7)).astype(np.float32), fletcher32=True,
                     chunks=(33, 7))
    f.create_dataset("odd", data=rng.integers(0, 255, size=(101,), dtype=np.uint8),
                     fletcher32=True, chunks=(101,))  # an odd byte count
    f.create_dataset("all", data=rng.normal(size=(50, 9)), fletcher32=True, shuffle=True,
                     compression="gzip", chunks=(17, 4))


def _edge_chunks(f, rng):
    f.create_dataset("x", data=rng.normal(size=(37, 11, 5)).astype(np.float32),
                     chunks=(8, 4, 3), compression="gzip")
    f.create_dataset("y", data=rng.integers(0, 99, size=(10,), dtype=np.int16), chunks=(7,))


def _big_endian(f, rng):
    f["f4"] = rng.normal(size=(6, 4)).astype(">f4")
    f.create_dataset("i8", data=rng.integers(-2**40, 2**40, size=(9,)).astype(">i8"),
                     chunks=(4,), compression="gzip")
    f.create_dataset("u2", data=rng.integers(0, 2**16, size=(3, 5)).astype(">u2"),
                     chunks=(2, 2), shuffle=True)


def _widths(f, rng):
    for dt in ("i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8"):
        info = np.iinfo(dt)
        vals = rng.integers(info.min, info.max, size=(4, 3), dtype=dt, endpoint=True)
        vals[0, :2] = info.min, info.max
        f[dt] = vals
    f["f2"] = rng.normal(size=(8,)).astype(np.float16)
    f["f8"] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, 1.5], np.float64)


def _ranks(f, rng):
    f["scalar"] = np.float64(3.25)
    f["scalar_int"] = np.int32(-7)
    f["one"] = np.arange(17, dtype=np.int32)
    f["three"] = rng.normal(size=(2, 3, 4)).astype(np.float32)
    f["rows0"] = np.zeros((0, 3), np.float32)
    f.create_dataset("rows0_chunked", shape=(0, 3), maxshape=(None, 3), dtype=np.float32,
                     chunks=(4, 3))
    f["null"] = h5py.Empty("f4")


def _unallocated(f, rng):
    f.create_dataset("x", shape=(4, 5), dtype=np.int32)
    f.create_dataset("filled", shape=(4, 5), dtype=np.float32, fillvalue=2.5)
    f.create_dataset("chunks", shape=(40, 6), dtype=np.int16, chunks=(8, 3), fillvalue=-3)
    f["chunks"][:9, :3] = 1  # two chunks written, the rest the fill value


def _compact(f, rng):
    space = h5py.h5s.create_simple((3, 4))
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_DOUBLE, space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, rng.normal(size=(3, 4)))


def _filter_mask(f, rng):
    """A chunk stored raw with the deflate filter marked skipped in its key."""
    ds = f.create_dataset("x", shape=(8, 4), dtype=np.int32, chunks=(4, 4), compression="gzip")
    ds[:4] = rng.integers(0, 9, size=(4, 4))
    ds.id.write_direct_chunk((4, 0), rng.integers(0, 9, size=(4, 4), dtype=np.int32).tobytes(),
                             filter_mask=1)


def _group_of_40(f, rng):
    for i in range(40):
        f[f"d{i:02d}_{'x' * (i % 7)}"] = np.full((2,), i, np.int16)


def _nested(f, rng):
    f["a/b/c"] = rng.normal(size=(3,)).astype(np.float32)
    f.create_dataset("a/z", data=np.arange(6, dtype=np.uint8).reshape(2, 3), chunks=(1, 3),
                     compression="gzip")
    f["top"] = np.int64(1)


def _linked_groups(f, rng):
    """A group reached by two links and holding a link to itself: walked
    once, as h5py's ``visititems`` visits it."""
    g = f.create_group("g")
    g["x"] = rng.normal(size=(4,)).astype(np.float32)
    g["self"] = g
    f["alias"] = g


CASES = {"contiguous": _contiguous, "pointnet_gzip": _pointnet, "shuffle_gzip": _shuffle_gzip,
         "fletcher32": _fletcher32, "edge_chunks": _edge_chunks, "big_endian": _big_endian,
         "widths_f2_f8": _widths, "ranks_scalar_0row_null": _ranks, "unallocated": _unallocated,
         "compact": _compact, "filter_mask": _filter_mask, "group_of_40": _group_of_40,
         "nested": _nested, "linked_groups": _linked_groups}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_as_h5py(tmp_path, case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        CASES[case](f, rng)
    listed = _assert_reads_as_h5py(path)
    if case == "group_of_40":
        assert len(listed) == 40
    if case == "nested":
        assert set(listed) == {"a/b/c", "a/z", "top"}
        np.testing.assert_array_equal(H.read_dataset(path, "/a/b/c"),
                                      H.read_dataset(path, "a/b/c"))


def test_user_block_and_missing_names(tmp_path):
    path = str(tmp_path / "u.h5")
    with h5py.File(path, "w", userblock_size=1024) as f:
        f["x"] = np.arange(5.0)
    _assert_reads_as_h5py(path)
    with pytest.raises(KeyError, match="nope"):
        H.read_dataset(path, "nope")
    with pytest.raises(ValueError, match="not a dataset|not a group"):
        H.read_dataset(path, "x/y")


_DTYPES = ("<f4", ">f4", "<f8", "<f2", "<i1", ">i2", "<i4", "<i8", "<u1", ">u2", "<u4", ">u8")


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(shape=st.lists(st.integers(1, 9), min_size=1, max_size=3),
       chunk_frac=st.lists(st.integers(1, 9), min_size=3, max_size=3),
       dtype=st.sampled_from(_DTYPES), gzip=st.sampled_from([None, 1, 9]),
       shuffle=st.booleans(), fletcher32=st.booleans(), seed=st.integers(0, 2**16))
def test_hypothesis_layouts(tmp_path, shape, chunk_frac, dtype, gzip, shuffle, fletcher32, seed):
    """Random shapes, chunk shapes (each axis 1 to its size), dtypes and
    filter pipelines, each read bit-equal to h5py (derandomized: the same
    examples every run)."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        arr = rng.normal(size=shape).astype(dt)
    else:
        info = np.iinfo(dt)
        arr = rng.integers(info.min, info.max, size=shape, dtype=dt.newbyteorder("="),
                           endpoint=True).astype(dt)
    chunks = tuple(max(1, min(s, c)) for s, c in zip(shape, chunk_frac))
    path = str(tmp_path / f"h{seed}.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=arr, chunks=chunks, compression="gzip" if gzip else None,
                         compression_opts=gzip, shuffle=shuffle, fletcher32=fletcher32)
        f["c"] = arr  # contiguous beside it
    _assert_reads_as_h5py(path)


def _corrupt_fletcher32(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype=np.float32), fletcher32=True,
                         chunks=(64,))
        offset = f["x"].id.get_chunk_info(0).byte_offset
    with open(path, "r+b") as fh:
        fh.seek(offset + 10)
        byte = fh.read(1)
        fh.seek(offset + 10)
        fh.write(bytes([byte[0] ^ 0x40]))


REFUSALS = {
    "libver_latest": (lambda p: _write(p, libver="latest", data=np.arange(3.0)),
                      "superblock version 3.*libver='latest'"),
    "lzf": (lambda p: _write(p, data=np.arange(300.0), compression="lzf"), r"filter 32000 \(lzf\)"),
    "vlen_string": (lambda p: _write(p, data="a string"), "variable-length string"),
    "fixed_string": (lambda p: _write(p, data=np.array([b"ab", b"cd"])), r"class 3 \(string\)"),
    "compound": (lambda p: _write(p, data=np.zeros(2, [("a", "<i4"), ("b", "<f4")])),
                 r"class 6 \(compound\)"),
    "enum_bool": (lambda p: _write(p, data=np.array([True, False])), r"class 8 \(enum\)"),
    "fletcher32_corrupt": (_corrupt_fletcher32, "fletcher32 checksum mismatch"),
    "track_order_ohdr": (lambda p: _write(p, track_order=True, data=np.arange(3.0)),
                         r"version 2 \(OHDR"),
}


def _write(path, libver=None, track_order=None, **kw):
    with h5py.File(path, "w", libver=libver, track_order=track_order) as f:
        f.create_dataset("x", **kw)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_the_feature(tmp_path, case):
    make, pattern = REFUSALS[case]
    path = str(tmp_path / "r.h5")
    make(path)
    with pytest.raises(ValueError, match=pattern):
        H.read_dataset(path, "x")


def test_not_hdf5(tmp_path):
    for content in (b"", b"plain text, not HDF5" * 40):
        (tmp_path / "n.h5").write_bytes(content)
        with pytest.raises(ValueError, match="not an HDF5 file"):
            H.list_datasets(str(tmp_path / "n.h5"))


def test_fletcher32_matches_hdf5_on_lengths():
    """The checksum against h5py's stored checksums over byte counts from 1
    to past a block of 360 words (its fold), by reading files whose single
    chunk has that many bytes."""
    for n in (1, 2, 3, 719, 720, 721, 722, 1441, 5000):
        import io

        buf = io.BytesIO()
        data = np.random.default_rng(n).integers(0, 256, size=(n,), dtype=np.uint8)
        with h5py.File(buf, "w") as f:
            f.create_dataset("x", data=data, chunks=(n,), fletcher32=True)
            info = f["x"].id.get_chunk_info(0)
        raw = buf.getvalue()[info.byte_offset:info.byte_offset + info.size]
        assert int.from_bytes(raw[-4:], "little") == H.fletcher32(raw[:-4]), n


def _sha(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_committed_fixture_matches_expected():
    """``tests/data/modelnet_h5`` (written by h5py with
    ``tests/torch_make_h5_fixture.py``) equal to its ``expected.json``
    through h5py and through the port's reader, and loaded by the port's
    ``load_modelnet_hdf5`` equal to the JAX package's."""
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        expected = json.load(f)
    assert sorted(expected) == ["ply_data_test0.h5", "ply_data_train0.h5"]
    for fname, datasets in expected.items():
        path = os.path.join(FIXTURE, fname)
        assert sorted(H.list_datasets(path)) == sorted(datasets) == ["data", "faceId", "label",
                                                                     "normal"]
        with h5py.File(path, "r") as f:
            for name, want in datasets.items():
                for arr in (f[name][()], H.read_dataset(path, name)):
                    assert [list(arr.shape), arr.dtype.str, _sha(arr)] == [
                        want["shape"], want["dtype"], want["sha256"]], (fname, name)
                assert f[name].compression == "gzip"
    for g, w in zip(load_modelnet_hdf5(FIXTURE), jax_hdf5.load_modelnet_hdf5(FIXTURE)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_fixture_writer_reads_back_through_h5py(tmp_path):
    """``benchmarks/modelnet_h5.py`` at a small size: h5py reads every
    dataset back exactly as given, with h5py's own chunk shapes and gzip
    levels (a chunk B-tree of two levels included), and the JAX package's
    ``load_modelnet_hdf5`` loads the directory equal to the port's."""
    files = MH.write_modelnet_h5(str(tmp_path), seed=3, train=(150, 9), test=(21,),
                                 num_points=1024)
    assert list(files) == ["ply_data_train0.h5", "ply_data_train1.h5", "ply_data_test0.h5"]
    for fname, arrays in files.items():
        with h5py.File(tmp_path / fname, "r") as f:
            assert sorted(f) == ["data", "faceId", "label", "normal"]
            for name, arr in arrays.items():
                ds = f[name]
                assert ds.dtype == arr.dtype and ds.shape == arr.shape, (fname, name)
                assert ds[()].tobytes() == arr.tobytes(), (fname, name)
                assert ds.compression == "gzip" and ds.compression_opts == MH.LEVELS[name]
                assert ds.chunks == MH.guess_chunk(arr.shape, arr.dtype.itemsize)
        _assert_reads_as_h5py(str(tmp_path / fname))
    assert files["ply_data_train0.h5"]["label"].shape == (150, 1)
    data = files["ply_data_train0.h5"]["data"]
    n_chunks = np.prod([-(-s // c) for s, c in zip(data.shape, MH.guess_chunk(data.shape, 4))])
    assert n_chunks > 2 * 32  # more than one B-tree leaf
    names = (tmp_path / "shape_names.txt").read_text().split()
    assert tuple(names) == MH.MODELNET40 and len(names) == 40
    got, want = load_modelnet_hdf5(str(tmp_path)), jax_hdf5.load_modelnet_hdf5(str(tmp_path))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    ds = OrientationDataset.from_hdf5(str(tmp_path))
    order = ["ply_data_test0.h5", "ply_data_train0.h5", "ply_data_train1.h5"]  # sorted files
    np.testing.assert_array_equal(ds.points, np.concatenate([files[f]["data"] for f in order]))
    np.testing.assert_array_equal(ds.labels,
                                  np.concatenate([files[f]["label"][:, 0] for f in order]))


def test_guess_chunk_matches_h5py():
    from h5py._hl import filters

    for shape, size in (((2048, 2048, 3), 4), ((2048, 1), 1), ((2048, 2048), 4),
                        ((420, 2048, 3), 4), ((1651, 1), 1), ((5, 64, 3), 4), ((1,), 8),
                        ((3, 1_000_000), 2), ((7, 2048, 3), 4)):
        assert MH.guess_chunk(shape, size) == filters.guess_chunk(shape, None, size), shape
    assert MH.guess_chunk((2048, 2048, 3), 4) == (128, 128, 1)

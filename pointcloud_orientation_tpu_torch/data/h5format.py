"""The HDF5 files that h5py writes by default (``libver="earliest"``) read
with numpy, ``struct`` and ``zlib``: no h5py is needed.

Such a file starts with a version 0 or 1 superblock, whose root symbol-table
entry names the root group's object header. Every object header is version
1: a 16-byte prefix, then messages aligned to 8 bytes, continued in other
blocks by continuation messages. A group is a symbol table: a version-1
B-tree of type 0 whose leaves are ``SNOD`` nodes of symbol-table entries,
their names in a local heap (``HEAP``). A dataset's header holds its
dataspace, datatype, fill value, layout and filter pipeline. Its data is
compact (in the layout message), contiguous (one extent; an undefined
address is storage never allocated, read as the fill value, zeros by
default) or chunked: a version-1 B-tree of type 1 whose keys hold each
chunk's stored size, filter mask and offset (rank + 1 numbers, the last the
element offset), each chunk stored at the full chunk shape (edge chunks
cropped here) and passed through the pipeline's filters in reverse:
deflate (a zlib stream, header included), shuffle (bytes regrouped by
position in the element) and fletcher32 (a checksum in the chunk's last 4
bytes, checked).

Read: superblock versions 0 and 1, with their sizes of offsets and lengths;
version-1 object headers (unknown messages skipped); symbol-table groups,
nested (``a/b/c``); dataspaces of versions 1 and 2 (simple, scalar, null);
fixed-point (1, 2, 4 and 8 bytes, signed or unsigned) and IEEE float (2, 4
and 8 bytes) datatypes in either byte order; layout message version 3,
compact, contiguous and chunked; filters deflate (1), shuffle (2) and
fletcher32 (3), each chunk's filter mask honoured; the fill value message
(both kinds). Anything else raises a ``ValueError`` that names it:
superblock versions 2 and 3 and ``OHDR`` object headers (``libver="latest"``),
layout version 4's chunk indexes, link messages and dense link storage,
external files, virtual datasets, other filters (lzf, szip, ...), and
strings, compounds, enums, references, arrays and variable-length types.

    list_datasets(path)        # {name: (shape, dtype)}, nested names "a/b"
    read_dataset(path, name)   # numpy array, the file's dtype, native order

Reading a dataset decompresses only that dataset's chunks (the file is
memory-mapped), on up to 8 threads. A null dataspace (``h5py.Empty``) has
shape ``None`` and reads as ``None``.
"""

from __future__ import annotations

import contextlib
import math
import mmap
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _PIPELINE, _CONTINUATION, _SYMBOL_TABLE = (
    0x6, 0x7, 0x8, 0xB, 0x10, 0x11)
_SHARED = 0x02  # message flag: stored elsewhere (a committed datatype, a shared message)

_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_THREADS = 8  # chunks decoded at once (zlib releases the GIL)
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc",
                 32004: "lz4", 32008: "bitshuffle", 32013: "zfp", 32015: "zstd"}
_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
# IEEE layouts by size: precision, exponent location and size, mantissa
# location and size, exponent bias
_IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
         8: (64, 52, 11, 0, 52, 1023)}


class _Dataset:
    """A dataset's header messages, decoded."""

    def __init__(self, name: str, shape: Optional[Tuple[int, ...]], dtype: np.dtype,
                 layout: tuple, filters: List[tuple], fill: Optional[bytes]):
        self.name, self.shape, self.dtype = name, shape, dtype
        self.layout, self.filters, self.fill = layout, filters, fill


class _File:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            try:
                self.buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError:  # an empty file
                raise ValueError(f"{path}: not an HDF5 file (empty)") from None
        self.path = path
        try:
            self._superblock()
        except Exception:
            self.buf.close()
            raise

    def close(self) -> None:
        self.buf.close()

    # ---- primitives ----

    def _error(self, msg: str) -> ValueError:
        return ValueError(f"{self.path}: {msg}")

    def _bytes(self, pos: int, n: int) -> bytes:
        if pos < 0 or pos + n > len(self.buf):
            raise self._error(f"{n} bytes at {pos} lie past the end of the file "
                              f"({len(self.buf)} bytes)")
        return self.buf[pos:pos + n]

    def _uint(self, raw: bytes, at: int, size: int) -> int:
        return int.from_bytes(raw[at:at + size], "little")

    def _undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.so)) - 1

    def _at(self, addr: int) -> int:
        """A file address as a position in the file (addresses count from
        the superblock's base address)."""
        return self.base + addr

    # ---- superblock ----

    def _superblock(self) -> None:
        pos = 0
        while self.buf[pos:pos + 8] != SIGNATURE:
            pos = 512 if pos == 0 else 2 * pos  # a user block of 512 bytes, 1024, ...
            if pos + 8 > len(self.buf):
                raise self._error("not an HDF5 file (no superblock signature)")
        head = self._bytes(pos, 24)
        version = head[8]
        if version in (2, 3):
            raise self._error(f"superblock version {version} (written under h5py's "
                              "libver='latest'): not read; only versions 0 and 1")
        if version not in (0, 1):
            raise self._error(f"superblock version {version}: not read; only 0 and 1")
        self.so, self.sl = head[13], head[14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise self._error(f"sizes of offsets {self.so} and lengths {self.sl}")
        at = pos + 24 + (4 if version == 1 else 0)  # v1: indexed storage K and reserved
        raw = self._bytes(at, 4 * self.so)
        self.base = self._uint(raw, 0, self.so)
        self.root = self._symbol_entry(at + 4 * self.so)[1]

    def _symbol_entry(self, pos: int) -> Tuple[int, int]:
        """A symbol-table entry: the link name's heap offset and the object
        header's address."""
        raw = self._bytes(pos, 2 * self.so)
        return self._uint(raw, 0, self.so), self._uint(raw, self.so, self.so)

    def _entry_size(self) -> int:
        return 2 * self.so + 24

    # ---- object headers ----

    def _messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """A version-1 object header's messages as (type, flags, data),
        continuation blocks followed."""
        pos = self._at(addr)
        if self._bytes(pos, 4) == b"OHDR":
            raise self._error(f"object header at {addr} is version 2 (OHDR, written under "
                              "h5py's libver='latest'): not read; only version 1")
        prefix = self._bytes(pos, 16)
        if prefix[0] != 1:
            raise self._error(f"object header at {addr}: version {prefix[0]}, only 1 is read")
        count = struct.unpack_from("<H", prefix, 2)[0]
        size = struct.unpack_from("<I", prefix, 8)[0]
        blocks, out = [(pos + 16, size)], []
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            raw = self._bytes(start, length)
            at = 0
            while at + 8 <= length and len(out) < count:
                mtype, msize, flags = struct.unpack_from("<HHB", raw, at)
                data = raw[at + 8:at + 8 + msize]
                if len(data) != msize:
                    raise self._error(f"object header at {addr}: a message runs past its block")
                if mtype == _CONTINUATION:
                    blocks.append((self._at(self._uint(data, 0, self.so)),
                                   self._uint(data, self.so, self.sl)))
                out.append((mtype, flags, data))
                at += 8 + msize
        return out

    # ---- groups ----

    def _members(self, addr: int, path: str) -> Dict[str, int]:
        """A symbol-table group's members: name -> object header address."""
        msgs = self._messages(addr)
        table = [d for t, _, d in msgs if t == _SYMBOL_TABLE]
        if not table:
            if any(t == _LINK_INFO for t, _, _ in msgs):
                info = next(d for t, _, d in msgs if t == _LINK_INFO)
                at = 2 + (8 if info[1] & 1 else 0)
                if not self._undefined(self._uint(info, at, self.so)):
                    raise self._error(f"group {path!r} keeps its links in dense storage (a "
                                      "fractal heap): not read; only symbol-table groups")
            if any(t == _LINK for t, _, _ in msgs):
                raise self._error(f"group {path!r} keeps its links as link messages (compact "
                                  "link storage): not read; only symbol-table groups")
            raise self._error(f"{path!r} is not a group")
        btree = self._uint(table[0], 0, self.so)
        heap = self._heap(self._uint(table[0], self.so, self.so))
        members: Dict[str, int] = {}
        for snod in self._btree_children(btree, 0):
            pos = self._at(snod)
            head = self._bytes(pos, 8)
            if head[:4] != b"SNOD":
                raise self._error(f"group {path!r}: no SNOD signature at {snod}")
            for i in range(struct.unpack_from("<H", head, 6)[0]):
                name_off, header = self._symbol_entry(pos + 8 + i * self._entry_size())
                members[self._name(heap, name_off)] = header
        return members

    def _heap(self, addr: int) -> Tuple[int, int]:
        """A local heap's data segment: (position, size)."""
        pos = self._at(addr)
        raw = self._bytes(pos, 8 + 2 * self.sl + self.so)
        if raw[:4] != b"HEAP":
            raise self._error(f"no local heap (HEAP) at {addr}")
        size = self._uint(raw, 8, self.sl)
        return self._at(self._uint(raw, 8 + 2 * self.sl, self.so)), size

    def _name(self, heap: Tuple[int, int], offset: int) -> str:
        seg = self._bytes(heap[0], heap[1])
        end = seg.find(b"\0", offset)
        if offset >= len(seg) or end < 0:
            raise self._error(f"a link name at heap offset {offset} is out of its heap")
        return seg[offset:end].decode("utf-8")

    def _btree_node(self, addr: int, node_type: int, key_size: int):
        """A version-1 B-tree node: (level, keys, children), each key the
        raw bytes of ``key_size``."""
        pos = self._at(addr)
        head = self._bytes(pos, 8 + 2 * self.so)
        if head[:4] != b"TREE":
            raise self._error(f"no B-tree node (TREE) at {addr}")
        if head[4] != node_type:
            raise self._error(f"B-tree node at {addr} has type {head[4]}, expected {node_type}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        step = key_size + self.so
        raw = self._bytes(pos + len(head), used * step + key_size)
        keys = [raw[i * step:i * step + key_size] for i in range(used + 1)]
        children = [self._uint(raw, i * step + key_size, self.so) for i in range(used)]
        return level, keys, children

    def _btree_children(self, addr: int, node_type: int, key_size: Optional[int] = None):
        """The leaf children of a version-1 B-tree (every level walked, each
        node one level below its parent); for type 1 also each one's key:
        [(key, address)]."""
        key_size = self.sl if key_size is None else key_size
        out, stack = [], [(addr, None)]
        while stack:
            node, want = stack.pop()
            level, keys, children = self._btree_node(node, node_type, key_size)
            if want is not None and level != want:
                raise self._error(f"B-tree node at {node} has level {level}, its parent's "
                                  f"child must have {want}")
            if level:
                stack.extend((c, level - 1) for c in reversed(children))
            else:
                out.extend(children if node_type == 0 else zip(keys, children))
        return out

    def _lookup(self, name: str) -> Tuple[str, int]:
        addr, path = self.root, ""
        for part in [p for p in name.split("/") if p]:
            members = self._members(addr, path or "/")
            if part not in members:
                raise KeyError(f"{self.path}: no object {name!r} (no {part!r} in "
                               f"{path or '/'!r})")
            addr, path = members[part], f"{path}/{part}" if path else part
        return path, addr

    def walk(self, addr: Optional[int] = None, prefix: str = "", seen=None):
        """Every dataset under the group at ``addr`` (the root by default),
        depth first in name order: (name, header address); a group reached
        again by another link is not walked again."""
        addr = self.root if addr is None else addr
        seen = {addr} if seen is None else seen
        for name, child in sorted(self._members(addr, prefix or "/").items()):
            full = f"{prefix}/{name}" if prefix else name
            msgs = self._messages(child)
            if any(t in (_SYMBOL_TABLE, _LINK_INFO, _LINK) for t, _, _ in msgs):
                if child not in seen:
                    seen.add(child)
                    yield from self.walk(child, full, seen)
            elif any(t == _LAYOUT for t, _, _ in msgs):
                yield full, child

    # ---- datasets ----

    def dataset(self, name: str, addr: Optional[int] = None) -> _Dataset:
        if addr is None:
            name, addr = self._lookup(name)
        shape, dtype, layout, fill, fill_old = None, None, None, None, None
        filters: List[tuple] = []
        has_space = False
        for mtype, flags, data in self._messages(addr):
            if flags & _SHARED and mtype in (_DATASPACE, _DATATYPE, _FILL, _PIPELINE):
                raise self._error(f"{name!r}: a shared message (type {mtype}, e.g. a committed "
                                  "datatype): not read")
            if mtype == _DATASPACE:
                shape, has_space = self._dataspace(data, name), True
            elif mtype == _DATATYPE:
                dtype = self._datatype(data, name)
            elif mtype == _LAYOUT:
                layout = self._layout(data, name)
            elif mtype == _PIPELINE:
                filters = self._pipeline(data, name)
            elif mtype == _FILL:
                fill = self._fill(data)
            elif mtype == _FILL_OLD:
                fill_old = data[4:4 + struct.unpack_from("<I", data, 0)[0]]
            elif mtype == _EXTERNAL:
                raise self._error(f"{name!r}: external data files: not read")
        if not has_space or dtype is None or layout is None:
            raise self._error(f"{name!r} is not a dataset (no dataspace, datatype or layout)")
        fill = fill_old if fill is None else fill
        if fill and len(fill) != dtype.itemsize:
            raise self._error(f"{name!r}: a fill value of {len(fill)} bytes for {dtype}")
        return _Dataset(name, shape, dtype, layout, filters, fill or None)

    def _dataspace(self, data: bytes, name: str) -> Optional[Tuple[int, ...]]:
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            at, kind = 8, 1 if rank else 0
        elif version == 2:
            at, kind = 4, data[3]
        else:
            raise self._error(f"{name!r}: dataspace message version {version}: not read")
        if kind == 2:
            return None  # null: no elements, not even a shape
        if flags & 2:
            raise self._error(f"{name!r}: a dataspace with a permutation index: not read")
        return tuple(self._uint(data, at + i * self.sl, self.sl) for i in range(rank))

    def _datatype(self, data: bytes, name: str) -> np.dtype:
        cls = data[0] & 0x0F
        bits = data[1] | data[2] << 8 | data[3] << 16
        size = struct.unpack_from("<I", data, 4)[0]
        if cls not in (0, 1):
            what = _CLASS_NAMES.get(cls, f"class {cls}")
            if cls == 9:
                what = "variable-length " + ("string" if bits & 0xF == 1 else "sequence")
            raise self._error(f"{name!r}: datatype class {cls} ({what}): not read; only "
                              "fixed-point and IEEE float")
        offset, precision = struct.unpack_from("<HH", data, 8)
        if offset != 0 or precision != 8 * size:
            raise self._error(f"{name!r}: a datatype of {precision} bits at bit {offset} in "
                              f"{size} bytes: not read")
        if cls == 0:
            if size not in (1, 2, 4, 8):
                raise self._error(f"{name!r}: an integer of {size} bytes: not read")
            kind = "i" if bits & 0x08 else "u"
            order = ">" if bits & 0x01 else "<"
        else:
            order_bits = (bits & 0x01) | (bits >> 5 & 0x02)
            if order_bits not in (0, 1):
                raise self._error(f"{name!r}: a float in VAX byte order: not read")
            layout = (precision, *struct.unpack_from("<BBBBI", data, 12))
            sign = bits >> 8 & 0xFF
            if size not in _IEEE or layout != _IEEE[size] or sign != 8 * size - 1:
                raise self._error(f"{name!r}: a float of {size} bytes that is not IEEE "
                                  f"(layout {layout}, sign bit {sign}): not read")
            kind, order = "f", ">" if order_bits else "<"
        return np.dtype(f"{order}{kind}{size}")

    def _layout(self, data: bytes, name: str) -> tuple:
        version, cls = data[0], data[1]
        if version == 4:
            raise self._error(f"{name!r}: layout message version 4 (its chunk indexes, written "
                              "under h5py's libver='latest'): not read; only version 3")
        if version != 3:
            raise self._error(f"{name!r}: layout message version {version}: not read; only 3")
        if cls == 0:
            size = struct.unpack_from("<H", data, 2)[0]
            return ("compact", data[4:4 + size])
        if cls == 1:
            return ("contiguous", self._uint(data, 2, self.so),
                    self._uint(data, 2 + self.so, self.sl))
        if cls == 2:
            ndims = data[2]
            addr = self._uint(data, 3, self.so)
            dims = struct.unpack_from(f"<{ndims}I", data, 3 + self.so)
            return ("chunked", addr, dims)
        if cls == 3:
            raise self._error(f"{name!r}: a virtual dataset: not read")
        raise self._error(f"{name!r}: layout class {cls}: not read")

    def _pipeline(self, data: bytes, name: str) -> List[tuple]:
        """The filter pipeline: [(id, flags, client data)] in the order the
        writer applied them."""
        version, count = data[0], data[1]
        if version not in (1, 2):
            raise self._error(f"{name!r}: filter pipeline message version {version}: not read")
        at = 8 if version == 1 else 2
        out = []
        for _ in range(count):
            fid = struct.unpack_from("<H", data, at)[0]
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", data, at + 2)[0]
                at += 2
            else:
                name_len = 0
            flags, nvals = struct.unpack_from("<HH", data, at + 2)
            at += 6 + name_len
            values = struct.unpack_from(f"<{nvals}I", data, at)
            at += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
                what = _FILTER_NAMES.get(fid, "unknown")
                raise self._error(f"{name!r}: filter {fid} ({what}): not read; only deflate, "
                                  "shuffle and fletcher32")
            out.append((fid, flags, values))
        return out

    @staticmethod
    def _fill(data: bytes) -> Optional[bytes]:
        """The fill value message's value (None where it gives none)."""
        version = data[0]
        if version == 3:
            if not data[1] & 0x20:
                return None
            size = struct.unpack_from("<I", data, 2)[0]
            return data[6:6 + size]
        defined = data[3]
        if version >= 2 and defined == 0:
            return None
        size = struct.unpack_from("<I", data, 4)[0]
        return data[8:8 + size] if size else None

    # ---- data ----

    def read(self, ds: _Dataset) -> Optional[np.ndarray]:
        if ds.shape is None:
            return None
        dtype = ds.dtype
        kind = ds.layout[0]
        if kind == "compact":
            out = self._whole(ds, ds.layout[1])
        elif kind == "contiguous":
            addr, size = ds.layout[1], ds.layout[2]
            if self._undefined(addr):
                out = self._filled(ds)
            else:
                out = self._whole(ds, self._bytes(self._at(addr), size))
        else:
            out = self._chunked(ds)
        return out.astype(dtype.newbyteorder("="), copy=False)

    def _filled(self, ds: _Dataset) -> np.ndarray:
        if ds.fill is None:
            return np.zeros(ds.shape, ds.dtype)
        return np.full(ds.shape, np.frombuffer(ds.fill, ds.dtype)[0], ds.dtype)

    def _whole(self, ds: _Dataset, raw: bytes) -> np.ndarray:
        n = math.prod(ds.shape) * ds.dtype.itemsize
        if len(raw) < n:
            raise self._error(f"{ds.name!r}: {len(raw)} bytes stored for {n}")
        return np.frombuffer(raw[:n], ds.dtype).reshape(ds.shape).copy()

    def _chunked(self, ds: _Dataset) -> np.ndarray:
        _, addr, dims = ds.layout
        rank = len(ds.shape)
        if len(dims) != rank + 1 or dims[-1] != ds.dtype.itemsize:
            raise self._error(f"{ds.name!r}: chunk dimensions {list(dims)} for shape "
                              f"{list(ds.shape)} of {ds.dtype}")
        chunk = tuple(dims[:rank])
        out = self._filled(ds)
        if self._undefined(addr) or not out.size:
            return out
        key_size = 8 + 8 * (rank + 1)
        nbytes = math.prod(chunk) * ds.dtype.itemsize

        def decode(entry):
            key, caddr = entry
            size, mask = struct.unpack_from("<II", key, 0)
            offsets = struct.unpack_from(f"<{rank}Q", key, 8)
            return offsets, self._unfilter(ds, self._bytes(self._at(caddr), size), mask)

        entries = self._btree_children(addr, 1, key_size)
        workers = min(_THREADS, os.cpu_count() or 1, len(entries) // 8)
        with ThreadPoolExecutor(workers) if workers > 1 else contextlib.nullcontext() as pool:
            for offsets, raw in pool.map(decode, entries) if pool else map(decode, entries):
                self._place(ds, out, chunk, offsets, raw, nbytes)
        return out

    def _place(self, ds: _Dataset, out: np.ndarray, chunk: Tuple[int, ...],
               offsets: Tuple[int, ...], raw: bytes, nbytes: int) -> None:
        """One decoded chunk into ``out``, cropped at the dataset's edge."""
        if len(raw) != nbytes:
            raise self._error(f"{ds.name!r}: the chunk at {list(offsets)} holds {len(raw)} "
                              f"bytes after its filters, a chunk of {list(chunk)} {ds.dtype} "
                              f"{nbytes}")
        region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, ds.shape))
        if any(r.start >= r.stop for r in region):
            raise self._error(f"{ds.name!r}: a chunk at {list(offsets)} lies outside "
                              f"{list(ds.shape)}")
        block = np.frombuffer(raw, ds.dtype).reshape(chunk)
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]

    def _unfilter(self, ds: _Dataset, raw: bytes, mask: int) -> bytes:
        for i in reversed(range(len(ds.filters))):
            if mask >> i & 1:
                continue  # the writer skipped this filter for this chunk
            fid = ds.filters[i][0]
            if fid == _DEFLATE:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    raise self._error(f"{ds.name!r}: a deflate chunk does not decompress "
                                      f"({e})") from None
            elif fid == _SHUFFLE:
                raw = unshuffle(raw, ds.dtype.itemsize)
            else:
                raw = self._fletcher32_strip(ds, raw)
        return raw

    def _fletcher32_strip(self, ds: _Dataset, raw: bytes) -> bytes:
        if len(raw) < 4:
            raise self._error(f"{ds.name!r}: a fletcher32 chunk of {len(raw)} bytes")
        body, stored = raw[:-4], struct.unpack("<I", raw[-4:])[0]
        want = fletcher32(body)
        if stored != want:
            raise self._error(f"{ds.name!r}: fletcher32 checksum mismatch in a chunk (stored "
                              f"{stored:#010x}, computed {want:#010x}): the data is corrupt")
        return body


def unshuffle(raw: bytes, size: int) -> bytes:
    """HDF5's shuffle filter undone: the first ``n`` bytes are every
    element's byte 0, the next ``n`` its byte 1, and so on; bytes past ``n *
    size`` stay where they are."""
    n = len(raw) // size
    if size == 1 or n < 2:
        return raw
    head = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
    return head + raw[n * size:]


def fletcher32(data: bytes) -> int:
    """HDF5's ``H5_checksum_fletcher32``: 16-bit big-endian words summed in
    blocks of 360, each block's sums folded to 16 bits with the carry added
    back, and a trailing odd byte as the high byte of a word."""
    words = np.frombuffer(data, ">u2", len(data) // 2).astype(np.int64)
    sum1 = sum2 = 0
    full = len(words) // 360 * 360
    if full:
        blocks = words[:full].reshape(-1, 360)
        totals = blocks.sum(axis=1).tolist()
        weighted = (blocks * np.arange(360, 0, -1)).sum(axis=1).tolist()
        for total, weight in zip(totals, weighted):
            sum2 += 360 * sum1 + weight
            sum1 += total
            sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
            sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    tail = words[full:]
    if len(tail):
        t = len(tail)
        sum2 += t * sum1 + int((tail * np.arange(t, 0, -1)).sum())
        sum1 += int(tail.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def list_datasets(path: str) -> Dict[str, Tuple[Optional[Tuple[int, ...]], np.dtype]]:
    """Every dataset of the file, nested ones as ``a/b/c``, depth first in
    name order: ``{name: (shape, dtype)}``; the dtype in native byte order,
    as :func:`read_dataset` returns it, the shape ``None`` for a null
    dataspace."""
    f = _File(path)
    try:
        out = {}
        for name, addr in f.walk():
            ds = f.dataset(name, addr)
            out[name] = (ds.shape, ds.dtype.newbyteorder("="))
        return out
    finally:
        f.close()


def read_dataset(path: str, name: str) -> Optional[np.ndarray]:
    """The dataset ``name`` (``a/b/c`` through nested groups) as a numpy
    array of its dtype in native byte order; ``None`` for a null dataspace.
    Only this dataset's storage is read and decompressed."""
    f = _File(path)
    try:
        return f.read(f.dataset(name))
    finally:
        f.close()

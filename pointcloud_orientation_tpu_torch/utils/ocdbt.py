"""The OCDBT key-value store that Orbax keeps a checkpoint in (tensorstore's
"optionally-cooperative distributed B+tree"), read and written with the
standard library, numpy and :mod:`.zstd`: no ``tensorstore`` is needed.

A store is a directory with a ``manifest.ocdbt`` and data files under
``d/``. Every manifest and B+tree node starts with a header (a magic number,
its length in bytes, a format version and a compression format: none or
zstd) and ends with the CRC-32C of what comes before it; integers are
LEB128 varints unless said otherwise.

- The manifest holds the store's config (uuid, manifest kind, the largest
  inline value, the largest decoded node, the version tree's arity and the
  nodes' compression) and the version tree: the newest versions inline (a
  generation, the root node's height and location, its key count, its
  bytes and its indirect values' bytes, a commit time), the older ones
  behind version-node references. A read takes the newest generation.
- A B+tree node has a height (0: a leaf), a table of the data files that it
  refers to, and its entries with prefix-compressed keys. A leaf's values
  are inline or indirect: ``(data file, offset, length)``. An interior
  entry's key is the least key of its subtree, and its first
  ``subtree_common_prefix_length`` bytes are left out of every key below it.
- A data file's path is relative to the store's directory. Orbax's
  multi-process layout writes each process's store under
  ``ocdbt.process_<i>/`` and then a root manifest whose tree refers to
  their files (``ocdbt.process_0/d/...``), so reading the root reads all.

:func:`list_keys` and :func:`read` open a store each call; :class:`Store`
opens it once. :func:`write_store` writes a store of one leaf node, with
nothing compressed. A format that this module does not handle (numbered
manifests, another format version or compression) raises ``ValueError``.
"""

from __future__ import annotations

import hashlib
import os
import struct
import time
from typing import Dict, List, Tuple

import numpy as np

from .zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root
_HEADER = 14  # magic, length, version 0 and compression as one-byte varints
_MAX_INLINE = 1024  # the largest value that write_store keeps in its leaf node


# ---------- CRC-32C ----------

def _crc_table() -> np.ndarray:
    table = np.zeros((8, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table[0, i] = c
    for k in range(1, 8):
        table[k] = (table[k - 1] >> 8) ^ table[0][table[k - 1] & 0xFF]
    return table


_CRC = _crc_table()
_CRC_LISTS = [row.tolist() for row in _CRC]


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``, eight bytes a step."""
    data = bytes(data)
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC_LISTS
    crc = 0xFFFFFFFF
    n8 = len(data) - len(data) % 8
    for lo, hi in zip(*(np.frombuffer(data[:n8], "<u4").reshape(-1, 2).T.tolist()
                        if n8 else ([], []))):
        lo ^= crc
        crc = (t7[lo & 0xFF] ^ t6[(lo >> 8) & 0xFF] ^ t5[(lo >> 16) & 0xFF] ^ t4[lo >> 24]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF] ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24])
    for b in data[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------- encoding ----------

class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        out = shift = 0
        data, pos = self.data, self.pos
        while True:
            if pos >= len(data):
                raise ValueError(f"{self.what} ends inside a varint")
            b = data[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                self.pos = pos
                return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what} is truncated")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node: header, checksum and compression checked."""
    if len(data) < 16:
        raise ValueError(f"{what} is truncated")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{what} has magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(data):
        raise ValueError(f"{what} says {length} bytes and has {len(data)}")
    if crc32c(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise ValueError(f"{what} fails its CRC-32C")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what} has OCDBT format version {version}; only 0 is read")
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress(body)
    raise ValueError(f"{what} has compression format {compression}; only none (0) and zstd (1) "
                     "are read")


def _frame(body: bytes, magic: int) -> bytes:
    """A manifest or node around ``body``, uncompressed."""
    head = struct.pack(">I", magic) + struct.pack("<Q", _HEADER + len(body) + 4) + b"\0\0"
    data = head + body
    return data + struct.pack("<I", crc32c(data))


def _read_files(r: _Reader) -> List[str]:
    """A data file table: the paths, each relative to the store."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the path is base path + relative path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        paths.append(prev.decode())
    return paths


def _write_files(paths: List[str]) -> bytes:
    out = [_varint(len(paths))]
    enc = [p.encode() for p in paths]
    prefix = [os.path.commonprefix([a, b]) for a, b in zip(enc, enc[1:])]
    out += [_varint(len(p)) for p in prefix]
    out += [_varint(len(e) - (len(prefix[i - 1]) if i else 0)) for i, e in enumerate(enc)]
    out += [_varint(0)] * len(enc)
    out += [e[len(prefix[i - 1]) if i else 0:] for i, e in enumerate(enc)]
    return b"".join(out)


def _read_keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, common


# ---------- reading ----------

class Ref:
    """Where a node or an indirect value lies: ``(path, offset, length)``."""
    __slots__ = ("path", "offset", "length")

    def __init__(self, path: str, offset: int, length: int):
        self.path, self.offset, self.length = path, offset, length


class Manifest:
    """A parsed ``manifest.ocdbt``: ``config`` and the newest version's
    ``generation``, ``root`` (a :class:`Ref`, None for an empty store),
    ``height`` and ``num_keys``; ``versions`` the inline versions'
    generations, ``version_nodes`` the references to older ones."""

    def __init__(self, data: bytes):
        r = _Reader(_unframe(data, MANIFEST_MAGIC, "manifest.ocdbt"), "manifest.ocdbt")
        uuid = r.take(16)
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"manifest kind {kind} (numbered manifests) is not read; only the "
                             "single manifest file (0)")
        self.config = {"uuid": uuid.hex(), "max_inline_value_bytes": r.varint(),
                       "max_decoded_node_bytes": r.varint(),
                       "version_tree_arity_log2": r.u8()}
        method = r.varint()
        if method == 1:
            self.config["compression"] = {"id": "zstd", "level": struct.unpack("<i", r.take(4))[0]}
        elif method == 0:
            self.config["compression"] = None
        else:
            raise ValueError(f"node compression method {method} is not read")
        files = _read_files(r)
        n = r.varint()
        gens, heights = r.varints(n), [r.u8() for _ in range(n)]
        fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        num_keys, _, _ = r.varints(n), r.varints(n), r.varints(n)
        r.take(8 * n)  # commit times
        m = r.varint()
        node_gens = r.varints(m)
        r.varints(3 * m)  # the version nodes' data files, offsets and lengths
        r.varints(m)  # their numbers of generations
        r.take(8 * m)  # commit times
        r.take(m)  # heights
        if r.pos != len(r.data):
            raise ValueError("manifest.ocdbt has bytes after its version tree")
        self.versions, self.version_nodes = gens, node_gens
        if n == 0:
            raise ValueError("manifest.ocdbt holds no version")
        i = int(np.argmax(gens))
        self.generation, self.height, self.num_keys = gens[i], heights[i], num_keys[i]
        self.root = (None if offs[i] == _MISSING or num_keys[i] == 0
                     else Ref(files[fids[i]], offs[i], lens[i]))


class Store:
    """An OCDBT store read once: ``keys()`` in order, ``read(key)``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        path = os.path.join(self.directory, "manifest.ocdbt")
        if not os.path.exists(path):
            raise ValueError(f"{directory} has no manifest.ocdbt (not an OCDBT store)")
        with open(path, "rb") as f:
            self.manifest = Manifest(f.read())
        self._values: Dict[bytes, object] = {}
        if self.manifest.root is not None:
            self._walk(self.manifest.root, self.manifest.height, b"")

    def _bytes(self, ref: Ref) -> bytes:
        with open(os.path.join(self.directory, ref.path), "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"{ref.path} is shorter than offset {ref.offset} + {ref.length}")
        return data

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        r = _Reader(_unframe(self._bytes(ref), NODE_MAGIC, f"B+tree node in {ref.path}"),
                    f"B+tree node in {ref.path}")
        if r.u8() != height:
            raise ValueError(f"B+tree node in {ref.path} is not of height {height}")
        files = _read_files(r)
        n = r.varint()
        if height == 0:
            keys, _ = _read_keys(r, n, False)
            lengths, kinds = r.varints(n), r.varints(n)
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"B+tree node in {ref.path} has a value kind other than 0, 1")
            fids, offs = r.varints(len(indirect)), r.varints(len(indirect))
            where = dict(zip(indirect, zip(fids, offs)))
            for i, key in enumerate(keys):
                if i in where:
                    fid, off = where[i]
                    self._values[prefix + key] = Ref(files[fid], off, lengths[i])
                else:
                    self._values[prefix + key] = r.take(lengths[i])
            if r.pos != len(r.data):
                raise ValueError(f"B+tree leaf in {ref.path} has bytes after its values")
            return
        keys, common = _read_keys(r, n, True)
        fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # each subtree's keys, bytes and indirect bytes
        for key, c, fid, off, ln in zip(keys, common, fids, offs, lens):
            self._walk(Ref(files[fid], off, ln), height - 1, prefix + key[:c])

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._values)

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` when the store has none."""
        value = self._values[key.encode()]
        return self._bytes(value) if isinstance(value, Ref) else value

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values


def list_keys(directory: str) -> List[str]:
    """Every key of the OCDBT store at ``directory``, sorted."""
    return Store(directory).keys()


def read(directory: str, key: str) -> bytes:
    """The value of ``key`` in the OCDBT store at ``directory``."""
    return Store(directory).read(key)


# ---------- writing ----------

def write_store(directory: str, items: Dict[str, bytes]) -> None:
    """Write ``items`` as an OCDBT store in ``directory``: one data file
    under ``d/`` holding the values above ``_MAX_INLINE`` bytes and
    then the one leaf node, and ``manifest.ocdbt`` at one generation,
    nothing compressed. The manifest is written last, by a rename."""
    keys = sorted(k.encode() for k in items)
    values = [bytes(items[k.decode()]) for k in keys]
    blob, indirect = bytearray(), []
    for i, v in enumerate(values):
        if len(v) > _MAX_INLINE:
            indirect.append((i, len(blob)))
            blob += v
    name = "d/" + hashlib.md5(b"".join(keys) + bytes(blob)).hexdigest()
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    body = [b"\0", _write_files([name]), _varint(len(keys))]
    body += [_varint(p) for p in prefix]
    body += [_varint(len(k) - (prefix[i - 1] if i else 0)) for i, k in enumerate(keys)]
    body += [k[prefix[i - 1] if i else 0:] for i, k in enumerate(keys)]
    ind = {i for i, _ in indirect}
    body += [_varint(len(v)) for v in values]
    body += [b"\1" if i in ind else b"\0" for i in range(len(keys))]
    body += [b"\0"] * len(indirect) + [_varint(off) for _, off in indirect]
    body += [v for i, v in enumerate(values) if i not in ind]
    node = _frame(b"".join(body), NODE_MAGIC)
    node_offset = len(blob)
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    with open(os.path.join(directory, name), "wb") as f:
        f.write(bytes(blob) + node)
    uuid = hashlib.md5(node).digest()
    manifest = b"".join([
        uuid, _varint(0), _varint(_MAX_INLINE), _varint(100_000_000), b"\4",
        _varint(0),  # config: single manifest, nodes uncompressed
        _write_files([name]), _varint(1),  # one inline version
        _varint(1), b"\0", _varint(0), _varint(node_offset), _varint(len(node)),
        _varint(len(keys)), _varint(len(node)), _varint(len(blob)),
        struct.pack("<Q", time.time_ns()), _varint(0),  # no version nodes
    ])
    tmp = os.path.join(directory, "manifest.ocdbt.tmp")
    with open(tmp, "wb") as f:
        f.write(_frame(manifest, MANIFEST_MAGIC))
    os.replace(tmp, os.path.join(directory, "manifest.ocdbt"))

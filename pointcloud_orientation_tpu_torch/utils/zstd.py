"""A Zstandard decoder (RFC 8878) in Python and numpy, for the chunks and
the key-value store of the JAX package's Orbax checkpoints
(:mod:`.ocdbt`, :mod:`.orbax_format`): no ``zstandard`` package is needed.

:func:`decompress` takes one frame or several in a row and handles what
an encoder emits without a dictionary: the
frame header (single segment or a window descriptor, the content size),
raw, RLE and compressed blocks; literals raw, RLE, Huffman-coded in one or
four streams, or treeless (the previous block's table); sequences whose
literal length, offset and match length codes are predefined, RLE, FSE
coded or repeated from the previous block, with the three repeat offsets;
and the optional content checksum (the low 32 bits of XXH64), which it
verifies. A frame that names a dictionary, or any malformed input, raises
:class:`ZstdError` (a ``ValueError``).

It sits on the load path, not the hot path. Huffman literals are decoded
with one table lookup a symbol on the ``max_bits`` window, the lookups for
every bit position of a stream made at once in numpy, then the chain of
positions followed four symbols a step (:func:`_huffman_stream`).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
_BLOCK_MAX = 128 * 1024


class ZstdError(ValueError):
    """A zstd input that this decoder does not take, or a corrupt one."""


# ---------- XXH64 (the content checksum) ----------

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (bytes-like) with ``seed``."""
    data = memoryview(data).cast("B")
    n = len(data)
    i = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        lanes = np.frombuffer(data[: n - n % 32], dtype="<u8").tolist()
        for j in range(0, len(lanes), 4):
            v1 = (_rotl((v1 + lanes[j] * _P2) & _M64, 31) * _P1) & _M64
            v2 = (_rotl((v2 + lanes[j + 1] * _P2) & _M64, 31) * _P1) & _M64
            v3 = (_rotl((v3 + lanes[j + 2] * _P2) & _M64, 31) * _P1) & _M64
            v4 = (_rotl((v4 + lanes[j + 3] * _P2) & _M64, 31) * _P1) & _M64
        i = n - n % 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (_rotl(h ^ _round(0, struct.unpack_from("<Q", data, i)[0]), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (struct.unpack_from("<I", data, i)[0] * _P1) & _M64, 23) * _P2
             + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl(h ^ (data[i] * _P5) & _M64, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------- bit readers ----------

class _ForwardBits:
    """Little-endian bits from the start of ``buf[start:end]`` (the FSE
    table descriptions)."""

    def __init__(self, buf, start: int, end: int):
        self.buf, self.pos, self.end = buf, start * 8, end * 8

    def read(self, n: int) -> int:
        if self.pos + n > self.end + 8:
            raise ZstdError("an FSE table description runs past its section")
        byte, shift = self.pos >> 3, self.pos & 7
        word = int.from_bytes(self.buf[byte: byte + 4], "little")
        self.pos += n
        return (word >> shift) & ((1 << n) - 1)

    def byte_end(self) -> int:
        if self.pos > self.end:
            raise ZstdError("an FSE table description runs past its section")
        return (self.pos + 7) >> 3


class _BackwardBits:
    """A zstd backward bit stream: read from its end, where the highest set
    bit of the last byte marks the start. Reading past the stream's
    beginning yields zeros and leaves ``pos`` negative (the overflow that
    the FSE weight decoding watches for)."""

    def __init__(self, buf, start: int, end: int):
        if end <= start or buf[end - 1] == 0:
            raise ZstdError("a backward bit stream has no end marker")
        self.data = bytes(8) + bytes(buf[start:end]) + bytes(8)
        self.pos = 8 * (end - start - 1) + buf[end - 1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        if self.pos < -32:
            raise ZstdError("a backward bit stream read far past its start")
        lo = self.pos + 64  # the 8 zero bytes in front
        byte, shift = lo >> 3, lo & 7
        word = int.from_bytes(self.data[byte: byte + 8], "little")
        return (word >> shift) & ((1 << n) - 1)


# ---------- FSE ----------

class _FseTable:
    __slots__ = ("log", "symbol", "nbits", "base")

    def __init__(self, log: int, symbol: List[int], nbits: List[int], base: List[int]):
        self.log, self.symbol, self.nbits, self.base = log, symbol, nbits, base


def _fse_build(norm: List[int], log: int) -> _FseTable:
    size = 1 << log
    symbol = [0] * size
    nxt = [0] * len(norm)
    high = size
    for s, p in enumerate(norm):
        if p == -1:
            high -= 1
            symbol[high] = s
            nxt[s] = 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, p in enumerate(norm):
        if p <= 0:
            continue
        nxt[s] = p
        for _ in range(p):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos >= high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("an FSE distribution does not fill its table")
    nbits, base = [0] * size, [0] * size
    for i in range(size):
        d = nxt[symbol[i]]
        nxt[symbol[i]] += 1
        nb = log - (d.bit_length() - 1)
        nbits[i] = nb
        base[i] = (d << nb) - size
    return _FseTable(log, symbol, nbits, base)


def _fse_rle(symbol: int) -> _FseTable:
    return _FseTable(0, [symbol], [0], [0])


def _fse_read(buf, start: int, end: int, max_log: int, max_symbols: int
              ) -> Tuple[_FseTable, int]:
    """An FSE table description at ``buf[start:]``: the table and the
    offset just after the description."""
    bits = _ForwardBits(buf, start, end)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} exceeds {max_log}")
    remaining = 1 << log
    norm: List[int] = []
    while remaining > 0:
        if len(norm) >= max_symbols:
            raise ZstdError("an FSE distribution has too many symbols")
        nb = (remaining + 1).bit_length()
        val = bits.read(nb)
        lower = (1 << (nb - 1)) - 1
        threshold = (1 << nb) - 1 - (remaining + 1)
        if (val & lower) < threshold:
            bits.pos -= 1
            val &= lower
        elif val > lower:
            val -= threshold
        p = val - 1
        remaining -= -p if p < 0 else p
        norm.append(p)
        if p == 0:
            while True:
                repeat = bits.read(2)
                norm.extend([0] * repeat)
                if repeat != 3:
                    break
    if remaining != 0 or len(norm) > max_symbols:
        raise ZstdError("a corrupt FSE distribution")
    return _fse_build(norm, log), bits.byte_end()


# the predefined distributions (RFC 8878 section 3.1.1.3.2.2)
_LL_DEFAULT = _fse_build([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                          2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = _fse_build([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                          1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                          -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = _fse_build([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                          -1, -1, -1, -1, -1], 5)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                              4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


# ---------- Huffman ----------

class _Huffman:
    __slots__ = ("max_bits", "symbol", "nbits")

    def __init__(self, max_bits: int, symbol: np.ndarray, nbits: np.ndarray):
        self.max_bits, self.symbol, self.nbits = max_bits, symbol, nbits


def _huffman_from_weights(weights: List[int]) -> _Huffman:
    total = sum(1 << (w - 1) for w in weights if w > 0)
    if total == 0:
        raise ZstdError("a Huffman table with no weights")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights that do not complete a tree")
    if max_bits > 11:
        raise ZstdError(f"a Huffman code of {max_bits} bits (at most 11)")
    weights = list(weights) + [left.bit_length()]
    bits = [max_bits + 1 - w if w > 0 else 0 for w in weights]
    count = [0] * (max_bits + 2)
    for b in bits:
        count[b] += 1
    size = 1 << max_bits
    symbol = np.zeros(size, np.uint8)
    nbits = np.zeros(size, np.uint8)
    start = [0] * (max_bits + 2)
    for b in range(max_bits, 0, -1):
        start[b - 1] = start[b] + count[b] * (1 << (max_bits - b))
        nbits[start[b]: start[b - 1]] = b
    if start[0] != size:
        raise ZstdError("a corrupt Huffman table")
    for s, b in enumerate(bits):
        if b:
            n = 1 << (max_bits - b)
            symbol[start[b]: start[b] + n] = s
            start[b] += n
    return _Huffman(max_bits, symbol, nbits)


def _huffman_read(buf, pos: int, end: int) -> Tuple[_Huffman, int]:
    """A Huffman tree description at ``buf[pos]``: the table and the offset
    after it."""
    header = buf[pos]
    pos += 1
    if header >= 128:  # direct 4-bit weights
        n = header - 127
        nbytes = (n + 1) // 2
        if pos + nbytes > end:
            raise ZstdError("Huffman weights run past the literals section")
        weights = []
        for b in buf[pos: pos + nbytes]:
            weights += [b >> 4, b & 15]
        return _huffman_from_weights(weights[:n]), pos + nbytes
    if pos + header > end:
        raise ZstdError("Huffman weights run past the literals section")
    table, start = _fse_read(buf, pos, pos + header, 6, 16)
    bits = _BackwardBits(buf, start, pos + header)
    s1, s2 = bits.read(table.log), bits.read(table.log)
    weights: List[int] = []
    sym, nb, base = table.symbol, table.nbits, table.base
    while True:  # two interleaved states until the stream overflows
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
        weights.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.pos < 0:
            weights.append(sym[s1])
            break
    if len(weights) > 255:
        raise ZstdError("too many Huffman weights")
    return _huffman_from_weights(weights), pos + header


_POSITIONS = np.arange(8 * _BLOCK_MAX + 8, dtype=np.int32)  # every bit position of a block
_JUMP = 4  # symbols a step when following a stream's chain of positions in Python


def _huffman_stream(buf, start: int, end: int, count: int, huf: _Huffman) -> np.ndarray:
    """``count`` symbols of one Huffman stream ``buf[start:end]``.

    The window of ``max_bits`` bits above every bit position is looked up
    at once (positions below the stream's start read zeros, as the format
    says); each position then names the next, its own minus the code's
    length. That chain, from the stream's end, is followed ``_JUMP``
    positions a step in Python and filled in between with numpy."""
    if count == 0:
        return np.zeros(0, np.uint8)
    if end <= start or buf[end - 1] == 0:
        raise ZstdError("a Huffman stream has no end marker")
    mb = huf.max_bits
    total = 8 * (end - start - 1) + buf[end - 1].bit_length() - 1
    if total + 2 > len(_POSITIONS):
        raise ZstdError("a Huffman stream longer than a block")
    raw = np.frombuffer(bytes(buf[start:end]), np.uint8)
    padded = np.concatenate([np.zeros(2, np.uint8), raw, np.zeros(3, np.uint8)]).astype(np.uint32)
    # word[b] holds bits 8b .. 8b+23 of the padded stream (16 zero bits in front),
    # flat[i] the mb bits from bit i: position p reads bits [p - mb, p), flat[p - mb + 16]
    word = padded[:-2] | padded[1:-1] << 8 | padded[2:] << 16
    flat = ((word[:, None] >> np.arange(8, dtype=np.uint32)) & ((1 << mb) - 1)).reshape(-1)
    window = flat[16 - mb: 16 - mb + total + 1]
    nxt = np.empty(total + 2, np.int32)
    np.subtract(_POSITIONS[: total + 1], huf.nbits[window], out=nxt[:-1])
    nxt[: mb + 1] = np.maximum(nxt[: mb + 1], -1)
    nxt[0] = nxt[-1] = -1  # position 0 ends the stream; -1 (past it) stays there
    jump = nxt
    for _ in range(_JUMP.bit_length() - 1):
        jump = jump[jump]
    jv = memoryview(jump)
    steps = -(-count // _JUMP)
    anchors = [0] * steps
    q = total
    for i in range(steps):
        anchors[i] = q
        q = jv[q]
    pos = np.empty((_JUMP, steps), np.int32)
    pos[0] = anchors
    for j in range(1, _JUMP):
        pos[j] = nxt[pos[j - 1]]
    pos = pos.T.reshape(-1)[:count]
    if nxt[pos[-1]] != 0 or pos.min() <= 0:
        raise ZstdError("a Huffman stream does not end on its last symbol")
    return huf.symbol[window[pos]]


# ---------- blocks ----------

class _FrameState:
    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.ll: Optional[_FseTable] = None
        self.of: Optional[_FseTable] = None
        self.ml: Optional[_FseTable] = None
        self.rep = [1, 4, 8]


def _literals(buf, pos: int, end: int, st: _FrameState) -> Tuple[bytes, int]:
    """The literals section at ``buf[pos]``: the literals and the offset of
    the sequences section."""
    b0 = buf[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw or RLE
        if fmt in (0, 2):
            size, hlen = b0 >> 3, 1
        elif fmt == 1:
            size, hlen = (b0 >> 4) + (buf[pos + 1] << 4), 2
        else:
            size, hlen = (b0 >> 4) + (buf[pos + 1] << 4) + (buf[pos + 2] << 12), 3
        pos += hlen
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals run past the block")
            return bytes(buf[pos: pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals run past the block")
        return bytes([buf[pos]]) * size, pos + 1
    hlen, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    header = int.from_bytes(buf[pos: pos + hlen], "little")
    mask = (1 << bits) - 1
    regen, comp = (header >> 4) & mask, (header >> (4 + bits)) & mask
    streams = 1 if fmt == 0 else 4
    pos += hlen
    stop = pos + comp
    if stop > end:
        raise ZstdError("compressed literals run past the block")
    if kind == 2:
        st.huffman, pos = _huffman_read(buf, pos, stop)
    elif st.huffman is None:
        raise ZstdError("treeless literals with no previous Huffman table")
    if streams == 1:
        out = _huffman_stream(buf, pos, stop, regen, st.huffman)
    else:
        if pos + 6 > stop:
            raise ZstdError("a four-stream jump table runs past the literals")
        s1, s2, s3 = struct.unpack_from("<3H", buf, pos)
        pos += 6
        bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
        if bounds[3] > stop:
            raise ZstdError("a corrupt four-stream jump table")
        each = (regen + 3) // 4
        counts = [each, each, each, regen - 3 * each]
        if counts[3] < 0:
            raise ZstdError("too few literals for four streams")
        out = np.concatenate([_huffman_stream(buf, bounds[i], bounds[i + 1], counts[i],
                                              st.huffman) for i in range(4)])
    return out.tobytes(), stop


def _seq_table(mode: int, buf, pos: int, end: int, default: _FseTable, prev, max_log: int,
               max_symbols: int, what: str) -> Tuple[_FseTable, int]:
    if mode == 0:
        return default, pos
    if mode == 1:
        if pos >= end:
            raise ZstdError(f"an RLE {what} code runs past the block")
        return _fse_rle(buf[pos]), pos + 1
    if mode == 2:
        return _fse_read(buf, pos, end, max_log, max_symbols)
    if prev is None:
        raise ZstdError(f"a repeated {what} table with none before it")
    return prev, pos


def _block(buf, pos: int, end: int, out: bytearray, st: _FrameState) -> None:
    """Decode the compressed block ``buf[pos:end]`` onto ``out``."""
    lits, pos = _literals(buf, pos, end, st)
    if pos >= end:
        raise ZstdError("a compressed block has no sequences section")
    n = buf[pos]
    if n == 0:
        out += lits
        return
    if n < 128:
        pos += 1
    elif n < 255:
        n, pos = ((n - 128) << 8) + buf[pos + 1], pos + 2
    else:
        n, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequences' compression modes")
    st.ll, pos = _seq_table(modes >> 6, buf, pos, end, _LL_DEFAULT, st.ll, 9, 36, "literal length")
    st.of, pos = _seq_table((modes >> 4) & 3, buf, pos, end, _OF_DEFAULT, st.of, 8, 32, "offset")
    st.ml, pos = _seq_table((modes >> 2) & 3, buf, pos, end, _ML_DEFAULT, st.ml, 9, 53,
                            "match length")
    bits = _BackwardBits(buf, pos, end)
    read = bits.read
    ll_t, of_t, ml_t = st.ll, st.of, st.ml
    ll_s, of_s, ml_s = read(ll_t.log), read(of_t.log), read(ml_t.log)
    rep = st.rep
    lit = 0
    for i in range(n):
        of_code, ml_code, ll_code = of_t.symbol[of_s], ml_t.symbol[ml_s], ll_t.symbol[ll_s]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("a sequence code out of range")
        offset = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset > 3:
            offset -= 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = offset - 1 + (ll == 0)
            if idx:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if idx > 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
            else:
                offset = rep[0]
        if i + 1 < n:
            ll_s = ll_t.base[ll_s] + read(ll_t.nbits[ll_s])
            ml_s = ml_t.base[ml_s] + read(ml_t.nbits[ml_s])
            of_s = of_t.base[of_s] + read(of_t.nbits[of_s])
        if lit + ll > len(lits):
            raise ZstdError("a sequence takes more literals than the block has")
        out += lits[lit: lit + ll]
        lit += ll
        start = len(out) - offset
        if offset == 0 or start < 0:
            raise ZstdError("a match offset before the frame's start")
        if offset >= ml:
            out += out[start: start + ml]
        else:  # overlapping: the pattern of ``offset`` bytes repeats
            pattern = bytes(out[start:])
            out += (pattern * (ml // offset + 1))[:ml]
    if bits.pos != 0:
        raise ZstdError("a sequences bit stream not consumed exactly")
    out += lits[lit:]


# ---------- frames ----------

def _frame(buf, pos: int) -> Tuple[bytes, int]:
    """One zstd frame at ``buf[pos]`` (after its magic): its content and the
    offset after it."""
    fhd = buf[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("a frame header with its reserved bit set")
    window = None
    if not single:
        wd = buf[pos]
        pos += 1
        exp, mant = wd >> 3, wd & 7
        base = 1 << (10 + exp)
        window = base + (base >> 3) * mant
    did_size = (0, 1, 2, 4)[did_flag]
    if did_size and int.from_bytes(buf[pos: pos + did_size], "little"):
        raise ZstdError("zstd frames that need a dictionary are not supported")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fcs_size:
        content = int.from_bytes(buf[pos: pos + fcs_size], "little") + (256 if fcs_size == 2
                                                                         else 0)
        pos += fcs_size
    if single:
        window = content
    block_max = min(window, _BLOCK_MAX) if window else _BLOCK_MAX
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > len(buf):
            raise ZstdError("a truncated zstd frame")
        header = buf[pos] | buf[pos + 1] << 8 | buf[pos + 2] << 16
        pos += 3
        last, kind, size = header & 1, (header >> 1) & 3, header >> 3
        if kind == 1:  # RLE: one byte, repeated
            if size > block_max or pos >= len(buf):
                raise ZstdError("a corrupt RLE block")
            out += bytes([buf[pos]]) * size
            pos += 1
        elif kind == 3:
            raise ZstdError("a block of the reserved type")
        else:
            if size > block_max or pos + size > len(buf):
                raise ZstdError("a block larger than the frame allows, or truncated")
            if kind == 0:
                out += buf[pos: pos + size]
            else:
                _block(buf, pos, pos + size, out, st)
            pos += size
        if last:
            break
    if content is not None and len(out) != content:
        raise ZstdError(f"a frame declared {content} bytes and decoded {len(out)}")
    if checksum:
        if pos + 4 > len(buf):
            raise ZstdError("a truncated content checksum")
        want = int.from_bytes(buf[pos: pos + 4], "little")
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("the content checksum does not match")
        pos += 4
    return bytes(out), pos


def decompress(data) -> bytes:
    """The content of every zstd frame in ``data``, in order. Raises
    :class:`ZstdError` on a frame that names a dictionary, on anything
    malformed (a skippable frame among it), and on trailing bytes."""
    buf = memoryview(data).cast("B")
    pos, parts = 0, []
    if len(buf) == 0:
        raise ZstdError("no zstd frame")
    while pos < len(buf):
        if pos + 4 > len(buf):
            raise ZstdError("trailing bytes after the last frame")
        magic = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        part, pos = _frame(buf, pos)
        parts.append(part)
    return b"".join(parts)

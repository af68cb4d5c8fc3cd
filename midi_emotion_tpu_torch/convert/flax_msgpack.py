"""Flax's msgpack checkpoint format, read and written in plain Python.

The counterpart of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize`` (flax 0.12, ``flax/serialization.py:250-430``) for
the subset of msgpack that Flax writes, so the port reads and writes the
JAX package's ``model.msgpack`` and ``optimizer.msgpack`` without the
``msgpack`` package, which the card's machine lacks.

What a Flax checkpoint holds:
  * nil, bool, ints (fixint to 64 bits), float32/64, str, bin, array and
    map; maps keep their insertion order (``to_bytes`` does not sort);
  * ext 1, an ndarray: the msgpack array ``(shape, dtype name, raw C-order
    bytes)`` packed as its payload; ext 2, a Python complex
    ``(real, imag)``; ext 3, a numpy scalar, packed as a 0-d ndarray;
  * an array larger than ``MAX_CHUNK_SIZE`` bytes as the map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
    "chunks": {"0": flat slice, ...}}``.

``decode`` returns dicts, lists and leaves: numpy arrays that view the
input buffer (``np.frombuffer``, no copy and no loop per element; read-only
when the input is ``bytes``), numpy scalars for ext 3, and torch tensors
for ``bfloat16``, which numpy has no type for. ``encode`` takes the same
kinds of tree (numpy arrays and scalars, torch tensors, Python scalars)
and gives the bytes of ``msgpack_serialize(tree, in_place=True)``, which
are ``to_bytes``'s for a tree of dicts (``to_bytes`` first turns lists and
tuples into maps by index): minimal ints, Python floats as float64, and
``strict_types`` (a numpy float64 is a numpy scalar, not a float; a tuple
is refused).
"""

from __future__ import annotations

import struct
from typing import Any, List, NamedTuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax/serialization.py:320
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, fmt: str):
        value = struct.unpack_from(fmt, self.view, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return value

    def _span(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.view):
            raise ValueError("flax msgpack: truncated input")
        return start

    def obj(self) -> Any:
        b = self.view[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            n = self._take(">" + "BHI"[b - 0xC4])
            start = self._span(n)
            return bytes(self.view[start:start + n])
        if b in (0xC7, 0xC8, 0xC9):
            n = self._take(">" + "BHI"[b - 0xC7])
            return self._ext(n)
        if b == 0xCA:
            return self._take(">f")
        if b == 0xCB:
            return self._take(">d")
        if 0xCC <= b <= 0xCF:
            return self._take(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self._take(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._take(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self._take(">" + "HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self._map(self._take(">" + "HI"[b - 0xDE]))
        raise ValueError(f"flax msgpack: unsupported type byte 0x{b:02x} at {self.pos - 1}")

    def _str(self, n: int) -> str:
        start = self._span(n)
        return str(self.view[start:start + n], "utf-8")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def _ext(self, n: int):
        code = self._take(">b")
        end = self.pos + n
        if code == EXT_COMPLEX:
            real, imag = self.obj()
            value = complex(real, imag)
        elif code in (EXT_NDARRAY, EXT_NPSCALAR):
            value = self._ndarray()
            if code == EXT_NPSCALAR:
                value = value[()]
        else:
            raise ValueError(f"flax msgpack: unsupported ext type {code}")
        if self.pos != end:
            raise ValueError("flax msgpack: ext payload length mismatch")
        return value

    def _ndarray(self):
        """(shape, dtype name, bin) -> an array over the input buffer."""
        if self.view[self.pos] != 0x93:
            raise ValueError("flax msgpack: an ndarray payload is not a 3-array")
        self.pos += 1
        shape = tuple(self.obj())
        name = self.obj()
        b = self.view[self.pos]
        self.pos += 1
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("flax msgpack: an ndarray payload holds no bin")
        n = self._take(">" + "BHI"[b - 0xC4])
        start = self._span(n)
        if name == _BF16:
            bits = np.frombuffer(self.buf, np.uint16, n // 2, start)
            if not bits.flags.writeable:  # torch wants a writable buffer
                bits = bits.copy()
            return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
        dtype = np.dtype(name)
        return np.frombuffer(self.buf, dtype, n // dtype.itemsize, start).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def decode(buf) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` gives for
    ``buf`` (bytes, bytearray or any buffer); arrays view ``buf``."""
    reader = _Reader(buf)
    out = reader.obj()
    if reader.pos != len(reader.view):
        raise ValueError("flax msgpack: trailing bytes after the tree")
    return out


def read(path: str) -> Any:
    """``decode`` of a file, read once into a writable buffer that the
    arrays share."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise OSError(f"{path}: short read")
    return decode(buf)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


class _Array(NamedTuple):
    """An array leaf reduced to the bytes Flax writes: a numpy array and
    the dtype name (bfloat16 as its uint16 bits)."""

    arr: np.ndarray
    name: str


def _as_array(x) -> _Array:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _Array(x.view(torch.int16).numpy().view(np.uint16), _BF16)
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("flax msgpack: object and structured dtypes are not serializable")
    return _Array(x, x.dtype.name)


def _map_value(v, max_chunk_size: int):
    """A map's value as Flax writes it: an array leaf reduced to an
    ``_Array``, or to its chunks past ``max_chunk_size`` bytes
    (``_chunk_array_leaves_in_place``); anything else as it is."""
    if not isinstance(v, (np.ndarray, torch.Tensor)):
        return v
    a = _as_array(v)
    return a if a.arr.nbytes <= max_chunk_size else _chunk(a, max_chunk_size)


def _int(out: List, n: int) -> None:
    """msgpack's minimal int encoding (msgpack/pack_template.h)."""
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        out.append(struct.pack(">b" if n < 0 else ">B", n))
    elif n >= 0:
        for limit, head, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if n < limit:
                out.append(bytes([head]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"flax msgpack: int {n} is too large")
    else:
        for limit, head, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if n >= -limit:
                out.append(bytes([head]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"flax msgpack: int {n} is too small")


def _head(out: List, n: int, small, fixed_max: int, wide) -> None:
    """A length header: ``small | n`` below ``fixed_max`` (when ``small``
    is not None), else the first of ``wide``'s (limit, head byte, format)
    that holds n."""
    if small is not None and n < fixed_max:
        out.append(bytes([small | n]))
        return
    for limit, head, fmt in wide:
        if n < limit:
            out.append(bytes([head]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"flax msgpack: length {n} is too large")


_STR = ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_BIN = ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I"))
_ARRAY = ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP = ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))
_EXT = ((1 << 8, 0xC7, ">B"), (1 << 16, 0xC8, ">H"), (1 << 32, 0xC9, ">I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext(out: List, code: int, payload: List) -> None:
    n = sum(len(p) for p in payload)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n]]))
    else:
        _head(out, n, None, 0, _EXT)
    out.append(struct.pack(">b", code))
    out.extend(payload)


def _ndarray_payload(arr: np.ndarray, name: str) -> List:
    """``msgpack.packb((shape, dtype name, bytes), use_bin_type=True)``,
    with the array's own buffer as the bin (no copy when contiguous)."""
    p: List = [b"\x93"]
    _head(p, len(arr.shape), 0x90, 16, _ARRAY)
    for d in arr.shape:
        _int(p, int(d))
    raw = name.encode()
    _head(p, len(raw), 0xA0, 32, _STR)
    p.append(raw)
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    _head(p, len(data), None, 0, _BIN)
    p.append(data)
    return p


def _chunk(a: _Array, max_chunk_size: int) -> dict:
    """flax/serialization.py ``_chunk``: flat slices of at most
    ``max_chunk_size`` bytes."""
    size = max(1, int(max_chunk_size / a.arr.dtype.itemsize))
    flat = a.arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(a.arr.shape)},
            "chunks": {str(n): _Array(flat[i:i + size], a.name)
                       for n, i in enumerate(range(0, flat.size, size))}}


def _pack(out: List, x: Any, max_chunk_size: int) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _int(out, x)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t in (bytes, bytearray):
        _head(out, len(x), None, 0, _BIN)
        out.append(bytes(x))
    elif t is str:
        raw = x.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, _STR)
        out.append(raw)
    elif t is dict:
        _head(out, len(x), 0x80, 16, _MAP)
        for k, v in x.items():
            _pack(out, k, max_chunk_size)
            _pack(out, _map_value(v, max_chunk_size), max_chunk_size)
    elif t is list:
        _head(out, len(x), 0x90, 16, _ARRAY)
        for v in x:
            _pack(out, v, max_chunk_size)
    elif t is _Array:
        _ext(out, EXT_NDARRAY, _ndarray_payload(*x))
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext(out, EXT_NDARRAY, _ndarray_payload(*_as_array(x)))
    elif isinstance(x, np.generic):
        arr = np.asarray(x)
        _ext(out, EXT_NPSCALAR, _ndarray_payload(arr, arr.dtype.name))
    elif t is complex:
        payload: List = [b"\x92", b"\xcb" + struct.pack(">d", x.real),
                         b"\xcb" + struct.pack(">d", x.imag)]
        _ext(out, EXT_COMPLEX, payload)
    else:
        raise TypeError(f"flax msgpack: can not serialize {t.__name__!r} object")


def encode_parts(tree: Any, max_chunk_size: int = MAX_CHUNK_SIZE) -> List:
    """The encoding of ``tree`` as a list of bytes-like parts (array data
    as views of the arrays, not copies)."""
    out: List = []
    _pack(out, _map_value(tree, max_chunk_size), max_chunk_size)
    return out


def encode(tree: Any, max_chunk_size: int = MAX_CHUNK_SIZE) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree,
    in_place=True)``: ``to_bytes``'s for a tree of dicts."""
    return b"".join(encode_parts(tree, max_chunk_size))


def write(path: str, tree: Any, max_chunk_size: int = MAX_CHUNK_SIZE) -> int:
    """Write ``encode(tree)`` to the file ``path`` part by part; returns
    the bytes written."""
    n = 0
    with open(path, "wb") as f:
        for part in encode_parts(tree, max_chunk_size):
            f.write(part)
            n += len(part)
    return n

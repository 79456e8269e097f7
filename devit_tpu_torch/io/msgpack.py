"""A msgpack decoder and encoder written out by hand, for the JAX package's
checkpoint files (counterpart of what devit_tpu/io/checkpoint.py reaches in
flax.serialization: `msgpack_restore` and `to_bytes`). The machine with the
card has no msgpack package, so the port carries its own.

The format (https://github.com/msgpack/msgpack/blob/master/spec.md): the
reader takes nil, bool, every int and float width, str, bin, array, map and
the ext formats. flax stores arrays in three ext codes:
- 1, ndarray: the payload is itself msgpack, [shape, dtype name, raw bytes]
  in C order, little-endian;
- 3, numpy scalar: the same payload with shape [] (save_compact's meta holds
  np.int32 / np.float32 scalars);
- 2, complex: not read; the reader raises on it.
Array leaves come back as numpy arrays (copies, writable and aligned), except
bfloat16, which numpy has no dtype for: read as uint16 and viewed as a
torch.bfloat16 tensor. A numpy scalar comes back as a numpy scalar (a 0-d
torch tensor for bfloat16). flax splits an array of more than
MAX_CHUNK_SIZE bytes into {"__msgpack_chunked_array__": True, "shape":
{"0": ..}, "chunks": {"0": .., "1": ..}}; `restore` joins them again.

The writer writes what flax writes (msgpack's Packer with strict types and
the bin type, flax's ext codes and chunking), byte for byte for trees of
str-keyed dicts with array, numpy-scalar, int, float, bool, str, bytes and
None leaves, so that the JAX package reads the port's files. torch tensors
are written as arrays of their dtype. Malformed input raises ValueError, as
msgpack's own errors do.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE: larger arrays are chunked
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext object of a code flax does not define, returned as it is."""
    code: int
    data: bytes


# ------------------------------------------------------------------ decoding

_FIXED = {  # type byte -> (struct format, size)
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_LEN = {  # type byte -> (kind, struct format of the length)
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self, depth: int = 0) -> Any:
        if depth > 512:
            raise ValueError("msgpack data nested deeper than 512")
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, depth)
        if 0x90 <= b <= 0x9f:
            return [self.read(depth + 1) for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _LEN:
            kind, fmt = _LEN[b]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "str":
                return self.str(n)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "array":
                return [self.read(depth + 1) for _ in range(n)]
            if kind == "map":
                return self.map(n, depth)
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack str is not utf-8: {e}") from None

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(depth + 1)
            if isinstance(key, (list, dict)):
                raise ValueError("msgpack map key is an array or a map")
            out[key] = self.read(depth + 1)
        return out


def unpackb(data) -> Any:
    """Decode one msgpack object (flax's ext codes included); raise
    ValueError on malformed or trailing data."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"extra data: {len(r.data) - r.pos} bytes after the msgpack object")
    return obj


def _array_from_payload(payload: bytes):
    """flax's [shape, dtype name, raw bytes] -> a numpy array (a torch
    tensor for bfloat16)."""
    try:
        shape, name, buf = unpackb(payload)
        name = name.decode() if isinstance(name, bytes) else name
        shape = tuple(int(s) for s in shape)
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed ndarray payload in msgpack data: {e}") from None
    if name == "bfloat16":
        a = np.frombuffer(buf, dtype="<u2").reshape(shape).copy()
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"unknown array dtype {name!r} in msgpack data") from e
    if dtype.hasobject:
        raise ValueError(f"object dtype {name!r} in msgpack data")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        a = _array_from_payload(data)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    if code == EXT_COMPLEX:
        raise ValueError("a complex number (flax ext code 2) in msgpack data: the port does "
                         "not read complex values")
    return ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
            return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data) -> Any:
    """flax.serialization.msgpack_restore: the decoded tree with chunked
    arrays joined."""
    return _unchunk(unpackb(data))


# ------------------------------------------------------------------ encoding


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else 8/16/32-bit lengths
    (codes: (8-bit or None, 16-bit, 32-bit))."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xff:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xffff:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xffffffff:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack length {n} is past 2^32 - 1")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack("b" if v < 0 else "B", v)
    elif 0x80 <= v <= 0xff:
        out += struct.pack("BB", 0xcc, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xd0, v)
    elif 0xff < v <= 0xffff:
        out += struct.pack(">BH", 0xcd, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xd1, v)
    elif 0xffff < v <= 0xffffffff:
        out += struct.pack(">BI", 0xce, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xd2, v)
    elif 0xffffffff < v <= 0xffffffffffffffff:
        out += struct.pack(">BQ", 0xcf, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xd3, v)
    else:
        raise OverflowError(f"integer {v} out of msgpack's range")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _header(out, n, None, -1, (0xc7, 0xc8, 0xc9))
    out += struct.pack("b", code)
    out += data


def _array_payload(a) -> bytes:
    """[shape, dtype name, raw C-order bytes], as flax's _ndarray_to_bytes."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            shape, name, raw = tuple(a.shape), "bfloat16", a.view(torch.int16).numpy().tobytes()
        else:
            n = a.numpy()
            shape, name, raw = n.shape, n.dtype.name, n.tobytes("C")
    else:
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not written")
        shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    out = bytearray()
    _pack(out, [list(shape), name, bytes(raw)])
    return bytes(out)


def _pack(out: bytearray, obj) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if obj else 0xc2)
    elif t is int:
        _pack_int(out, obj)
    elif t in (bytes, bytearray):
        _header(out, len(obj), None, -1, (0xc4, 0xc5, 0xc6))
        out += obj
    elif t is str:
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xa0, 0x1f, (0xd9, 0xda, 0xdb))
        out += raw
    elif t is float:
        out += struct.pack(">Bd", 0xcb, obj)
    elif t is list:
        _header(out, len(obj), 0x90, 0x0f, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _header(out, len(obj), 0x80, 0x0f, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, ExtType):
        _pack_ext(out, obj.code, obj.data)
    else:
        raise TypeError(f"cannot write {t.__name__} to msgpack")


def packb(obj) -> bytes:
    """Encode `obj` as msgpack.packb(obj, default=flax's ext packer,
    strict_types=True) does."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def _chunk(a) -> dict:
    """flax's _chunk: an oversized array as a dict of flat chunks."""
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(a.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def state_dict(tree) -> Any:
    """flax's to_state_dict for plain trees, with flax's chunking: dicts get
    str keys, lists, tuples and named tuples become {"0": ..} / {field: ..}
    maps, arrays above MAX_CHUNK_SIZE bytes are chunked; leaves stay."""
    if isinstance(tree, dict):
        if len({str(k) for k in tree}) != len(tree):
            raise ValueError(f"dict keys without a unique string form: {list(tree)}")
        return {str(k): state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(tree) -> bytes:
    """flax.serialization.to_bytes for plain trees."""
    return packb(state_dict(tree))

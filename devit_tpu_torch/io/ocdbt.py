"""tensorstore's OCDBT key-value store, read and written by hand (the store
under every orbax checkpoint the JAX package writes, `"use_ocdbt": true`).

On disk, below the store's root directory:
- `manifest.ocdbt`: the config and the version list; each version names
  the root of a b-tree by (data file, offset, length) and its height.
- `d/<name>`: data files. Each holds b-tree nodes and values too large to
  sit in a node (more than `max_inline_value_bytes`), back to back.
  Values are stored raw (a zarr chunk is already a zstd frame); nodes and
  manifests are framed.

A frame: the magic (u32 big-endian: 0x0cdb3a2a a manifest, 0x0cdb20de a
b-tree node), the frame's whole length (u64 little-endian), the format
version (varint, 0), the compression (varint: 0 none, 1 zstd), the body
(one zstd frame when compressed) and a CRC-32C of every byte before it
(u32 little-endian). The checksum covers manifests and nodes only.

Body fields are varints unless said otherwise; columns hold one value per
entry. A data file table starts each body that refers to files: the count,
then per file the length of the prefix it shares with the previous file's
path (from the second file on), the length of the rest, the length of its
base path, then the rests back to back. A path is the base path followed
by the relative path, relative to the store's root, and a node's table
takes the base path of the file it was reached through before its own:
orbax merges each process's store `ocdbt.process_<i>/` into the root store
by naming the process's data files with the base path `ocdbt.process_<i>/`.

- Manifest body: the config (uuid: 16 bytes; manifest kind: 0 single;
  max_inline_value_bytes; max_decoded_node_bytes;
  version_tree_arity_log2: u8; compression: 0 none, or 1 zstd and its
  level as an i32), the data file table, the versions (count; columns:
  generation, root height (u8), file, offset, length, key count, tree
  bytes, out-of-line value bytes, commit time (u64 ns)), then the version
  tree's older nodes (count, 0 here). The last version is the newest.
- B-tree node body: the height (u8; 0 a leaf), the data file table, the
  entry count, the keys (columns: the length each key shares with the one
  before it, from the second on; the length of its rest; for an interior
  node, the length of the prefix its whole subtree shares; then the rests
  back to back). A leaf then has the value lengths, the value kinds (one
  byte each: 0 inline, 1 in a data file), the file and the offset of each
  out-of-line value, and the inline values back to back. An interior node
  has its children's file, offset, length, key count, tree bytes and
  out-of-line value bytes. Keys below an interior entry are stored without
  the subtree prefix their parent names.

`Store` reads whatever tensorstore writes there (any height, compressed or
not, values inline or out of line, several data files). `write_store`
writes one process's store and the root store orbax merges it into: one
version, one leaf, the values above the inline limit in one data file.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from devit_tpu_torch.io import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MANIFEST = "manifest.ocdbt"
PROCESS_DIR = "ocdbt.process_0"
# orbax's settings (tensorstore_utils.add_ocdbt_write_options); version-tree
# arity and zstd level are tensorstore's defaults
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


# ------------------------------------------------------------ primitives

def _crc32c_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1).astype(np.uint32)
    return t


_CRC_TABLE = [int(x) for x in _crc32c_table()]


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected, as tensorstore's frames carry it;
    zlib.crc32 is the IEEE polynomial)."""
    c, t = 0xFFFFFFFF, _CRC_TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"varint of a negative number {n}")
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated ({n} bytes wanted at {self.pos} "
                             f"of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        r = shift = 0
        while True:
            b = self.byte()
            r |= (b & 0x7F) << shift
            if b < 0x80:
                return r
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} trailing bytes")


def _frame(magic: int, body: bytes, compress: bool) -> bytes:
    """A manifest or node frame: header, body (zstd when `compress`), CRC."""
    payload = zstd.compress(body, 0) if compress else body
    head = _varint(FORMAT_VERSION) + _varint(1 if compress else 0)
    n = 4 + 8 + len(head) + len(payload) + 4
    out = struct.pack(">I", magic) + struct.pack("<Q", n) + head + payload
    return out + struct.pack("<I", crc32c(out))


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    if len(data) < 16:
        raise ValueError(f"{what}: {len(data)} bytes is too short for a frame")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic 0x{got:08x}, expected 0x{magic:08x}")
    n = struct.unpack("<Q", data[4:12])[0]
    if n != len(data):
        raise ValueError(f"{what}: frame says {n} bytes, {len(data)} read")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version, comp = r.varint(), r.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"{what}: format version {version} (only {FORMAT_VERSION} is known)")
    payload = data[r.pos:-4]
    if comp == 0:
        return payload
    if comp == 1:
        return zstd.decompress(payload)
    raise ValueError(f"{what}: unknown compression {comp}")


# ------------------------------------------------------------ structures


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    zstd_level: Optional[int]  # None: nodes uncompressed


class Ref(NamedTuple):
    """A byte range of a data file; `path` relative to the store's root,
    `base` its base path (the prefix the file's own references take)."""
    path: str
    offset: int
    length: int
    base: str = ""


class Version(NamedTuple):
    generation: int
    height: int
    root: Ref
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time_ns: int


def _read_config(r: _Reader) -> Config:
    uid = r.take(16)
    kind, inline, node_bytes = r.varint(), r.varint(), r.varint()
    arity = r.byte()
    comp = r.varint()
    if comp == 0:
        level = None
    elif comp == 1:
        level = struct.unpack("<i", r.take(4))[0]
    else:
        raise ValueError(f"{r.what}: unknown config compression {comp}")
    return Config(uid, kind, inline, node_bytes, arity, level)


def _write_config(c: Config) -> bytes:
    out = c.uuid + _varint(c.manifest_kind) + _varint(c.max_inline_value_bytes)
    out += _varint(c.max_decoded_node_bytes) + bytes([c.version_tree_arity_log2])
    if c.zstd_level is None:
        return out + _varint(0)
    return out + _varint(1) + struct.pack("<i", c.zstd_level)


def _read_file_table(r: _Reader, transitive: str) -> List[Tuple[str, str]]:
    """(base path, path) of each file, both with the referring file's base
    path `transitive` before them."""
    n = r.varint()
    shared = r.varints(n - 1) if n else []
    rest = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        full = (prev[:shared[i - 1]] if i else b"") + r.take(rest[i])
        if base_len[i] > len(full):
            raise ValueError(f"{r.what}: base path longer than the path")
        files.append((transitive + full[:base_len[i]].decode(), transitive + full.decode()))
        prev = full
    return files


def _write_file_table(files: List[Tuple[str, str]]) -> bytes:
    """files: (base path, relative path), sorted by their joined path."""
    full = [(b + p).encode() for b, p in files]
    out = bytearray(_varint(len(files)))
    shared = [os.path.commonprefix([full[i - 1], full[i]]) for i in range(1, len(full))]
    for s in shared:
        out += _varint(len(s))
    for i, f in enumerate(full):
        out += _varint(len(f) - (len(shared[i - 1]) if i else 0))
    for b, _ in files:
        out += _varint(len(b.encode()))
    for i, f in enumerate(full):
        out += f[len(shared[i - 1]) if i else 0:]
    return bytes(out)


def _read_keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    shared = r.varints(n - 1) if n else []
    rest = r.varints(n)
    subtree = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        k = (prev[:shared[i - 1]] if i else b"") + r.take(rest[i])
        keys.append(k)
        prev = k
    return keys, subtree


def _write_keys(keys: List[bytes]) -> bytes:
    shared = [len(os.path.commonprefix([keys[i - 1], keys[i]])) for i in range(1, len(keys))]
    out = bytearray(_varint(len(keys)))
    for s in shared:
        out += _varint(s)
    for i, k in enumerate(keys):
        out += _varint(len(k) - (shared[i - 1] if i else 0))
    for i, k in enumerate(keys):
        out += k[shared[i - 1] if i else 0:]
    return bytes(out)


def _ref(file: Tuple[str, str], offset: int, length: int) -> "Ref":
    return Ref(file[1], offset, length, file[0])


# ------------------------------------------------------------ reading

Value = Union[bytes, Ref]


class Store:
    """The newest version of the OCDBT store at `root` (a directory):
    `keys()`, `get(key)`, `ref(key)` (inline bytes or the data-file range
    of an out-of-line value) and the tree's `heights` and `node_count`
    as read."""

    def __init__(self, root: str):
        self.root = root
        mpath = os.path.join(root, MANIFEST)
        if not os.path.isfile(mpath):
            raise FileNotFoundError(f"{root!r} holds no OCDBT manifest ({MANIFEST})")
        with open(mpath, "rb") as f:
            body = _unframe(f.read(), MANIFEST_MAGIC, mpath)
        r = _Reader(body, mpath)
        self.config = _read_config(r)
        files = _read_file_table(r, "")
        n = r.varint()
        gen = r.varints(n)
        height = [r.byte() for _ in range(n)]
        fid, off, length, nk, ntb, niv = (r.varints(n) for _ in range(6))
        when = [struct.unpack("<Q", r.take(8))[0] for _ in range(n)]
        self.versions = [Version(gen[i], height[i], _ref(files[fid[i]], off[i], length[i]),
                                 nk[i], ntb[i], niv[i], when[i]) for i in range(n)]
        if not self.versions:
            raise ValueError(f"{mpath}: the store has no version")
        self.version = self.versions[-1]
        self._entries: Dict[bytes, Value] = {}
        self.heights: List[int] = []
        self._walk(self.version.root, self.version.height, b"")
        if len(self._entries) != self.version.num_keys:
            raise ValueError(f"{root}: {len(self._entries)} keys read, the manifest counts "
                             f"{self.version.num_keys}")

    def read_range(self, ref: Ref) -> bytes:
        with open(os.path.join(self.root, ref.path), "rb") as f:
            data = os.pread(f.fileno(), ref.length, ref.offset)
        if len(data) != ref.length:
            raise ValueError(f"{ref.path}: {len(data)} bytes at {ref.offset}, "
                             f"{ref.length} expected")
        return data

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"b-tree node {ref.path}@{ref.offset}"
        body = _unframe(self.read_range(ref), NODE_MAGIC, what)
        if len(body) > self.config.max_decoded_node_bytes:
            raise ValueError(f"{what}: {len(body)} bytes decoded, over the store's "
                             f"max_decoded_node_bytes")
        r = _Reader(body, what)
        h = r.byte()
        if h != height:
            raise ValueError(f"{what}: height {h}, its parent says {height}")
        self.heights.append(h)
        files = _read_file_table(r, ref.base)
        n = r.varint()
        keys, subtree = _read_keys(r, n, interior=h > 0)
        if h == 0:
            lengths = r.varints(n)
            kinds = list(r.take(n))
            out = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"{what}: unknown value kind")
            fid, off = r.varints(len(out)), r.varints(len(out))
            for j, i in enumerate(out):
                self._entries[prefix + keys[i]] = _ref(files[fid[j]], off[j], lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    self._entries[prefix + keys[i]] = r.take(lengths[i])
            r.done()
            return
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # the children's statistics
        r.done()
        for i in range(n):
            self._walk(_ref(files[fid[i]], off[i], length[i]), h - 1,
                       prefix + keys[i][:subtree[i]])

    @property
    def node_count(self) -> int:
        return len(self.heights)

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._entries)

    def ref(self, key: str) -> Value:
        try:
            return self._entries[key.encode()]
        except KeyError:
            raise KeyError(f"{self.root}: no key {key!r}") from None

    def get(self, key: str) -> bytes:
        v = self.ref(key)
        return v if isinstance(v, bytes) else self.read_range(v)


# ------------------------------------------------------------ writing


def _data_name() -> str:
    return "d/" + uuid.uuid4().hex


def _leaf(entries: List[Tuple[bytes, Union[bytes, Tuple[int, int]]]], file: Tuple[str, str],
          ) -> bytes:
    """A leaf node body: entries sorted by key, each value inline bytes or
    (offset, length) in `file`."""
    indirect = [v for _, v in entries if isinstance(v, tuple)]
    out = bytearray([0])
    out += _write_file_table([file] if indirect else [])
    out += _write_keys([k for k, _ in entries])
    for _, v in entries:
        out += _varint(v[1] if isinstance(v, tuple) else len(v))
    out += bytes(1 if isinstance(v, tuple) else 0 for _, v in entries)
    out += b"".join(_varint(0) for _ in indirect)
    out += b"".join(_varint(off) for off, _ in indirect)
    for _, v in entries:
        if not isinstance(v, tuple):
            out += v
    return bytes(out)


def _manifest(config: Config, node: Tuple[str, int, int], num_keys: int, indirect: int,
              when: int) -> bytes:
    path, offset, length = node
    body = _write_config(config) + _write_file_table([("", path)])
    body += _varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(offset)
    body += _varint(length) + _varint(num_keys) + _varint(length) + _varint(indirect)
    body += struct.pack("<Q", when) + _varint(0)
    return _frame(MANIFEST_MAGIC, body, compress=True)


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def write_store(root: str, items: Iterable[Tuple[str, bytes]]) -> Config:
    """Write `items` (key, value) as orbax lays out one process's OCDBT
    store, merged: `root/ocdbt.process_0/` (its manifest, one data file with
    the out-of-line values and the leaf) and the root store `root/` (its
    manifest and a leaf naming the same values under the base path
    `ocdbt.process_0/`). Every file is fsynced. `items` may be a generator:
    each large value is written as it comes. Returns the config."""
    proc = os.path.join(root, PROCESS_DIR)
    os.makedirs(os.path.join(proc, "d"), exist_ok=True)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    config = Config(uuid.uuid4().bytes, 0, MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES,
                    VERSION_TREE_ARITY_LOG2, 0)
    data = _data_name()
    entries: Dict[bytes, Union[bytes, Tuple[int, int]]] = {}
    indirect = 0
    with open(os.path.join(proc, data), "wb") as f:
        for key, value in items:
            k = key.encode()
            if k in entries:
                raise ValueError(f"OCDBT write: key {key!r} given twice")
            if len(value) > MAX_INLINE_VALUE_BYTES:
                entries[k] = (f.tell(), len(value))
                f.write(value)
                indirect += len(value)
            else:
                entries[k] = bytes(value)
        ordered = sorted(entries.items())
        body = _leaf(ordered, ("", data))
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"OCDBT write: a leaf of {len(body)} bytes is over "
                             f"max_decoded_node_bytes; this writer emits one leaf")
        node = _frame(NODE_MAGIC, body, compress=True)
        node_at = f.tell()
        f.write(node)
        f.flush()
        os.fsync(f.fileno())
    when = time.time_ns()
    _write_file(os.path.join(proc, MANIFEST),
                _manifest(config, (data, node_at, len(node)), len(ordered), indirect, when))
    top = _frame(NODE_MAGIC, _leaf(ordered, (PROCESS_DIR + "/", data)), compress=True)
    top_name = _data_name()
    _write_file(os.path.join(root, top_name), top)
    _write_file(os.path.join(root, MANIFEST),
                _manifest(config, (top_name, 0, len(top)), len(ordered), indirect, when))
    return config

"""The orbax checkpoint directory, read and written without orbax: what the
JAX package's `save_pytree_orbax` (orbax StandardCheckpointer, OCDBT, zarr
v2, zstd) leaves on disk, and what its `restore_pytree_orbax` reads back,
raw or with a template.

A checkpoint directory holds:
- `_METADATA`: JSON. `tree_metadata` maps each leaf's key path, written as
  Python's repr of the tuple of its keys, to `key_metadata` (per key:
  `key` and `key_type`, 1 a sequence index, 2 a dict key) and
  `value_metadata` (`value_type`: "jax.Array" with its `write_shape`,
  "np.ndarray", or an empty value's type, "None", "Dict", "List", "Tuple"
  or "NamedTuple", with `skip_deserialize` true). `use_ocdbt` true,
  `use_zarr3` false.
- `_CHECKPOINT_METADATA`, `_sharding` (each jax.Array leaf's sharding, by
  the base64 of its name) and `array_metadatas/process_0` (each jax.Array
  leaf's write and chunk shape).
- The OCDBT store (io/ocdbt.py) with one zarr v2 array per array leaf,
  under the leaf's name (its keys joined by "."): `<name>/.zarray` (shape,
  chunk grid, dtype, `"compressor": {"id": "zstd", "level": 1}`, C order,
  fill_value null) and one zstd frame per chunk, `<name>/0.0` (a 0-d
  array's chunk is `<name>/0`).

The raw read (`read_checkpoint`) gives the tree the port's msgpack
`restore_pytree` gives for the same state, so callers take either format
through one code path: nested dicts, a sequence's elements under the keys
"0", "1", ..., numpy leaves (bfloat16 as torch tensors, as io/msgpack.py
returns them), 0-d arrays for scalars; an empty value as the JAX package's
raw orbax restore gives it (None for "None" and "NamedTuple", {} for the
empty containers).

The writer (`write_checkpoint`) records what orbax records for the JAX
package's tree of the same state. Which leaves the JAX package held on
the device is the caller's to say (`device_state`, the top-level keys of
device state): those arrays are written as a jax.Array ("jax.Array",
single-device sharding on the JAX CPU device `TFRT_CPU_0`, one chunk of
the whole shape), every other array, numpy or torch, as "np.ndarray"; a
dict whose keys are "0" ... "n-1" is the state-dict form of
a tuple (an optax state) and is written as a sequence; an empty dict is the
state-dict form of an empty optax state (EmptyState, MaskedState's
inner_state) and is written, as orbax writes those, as "None"; None is
"None". Zero-size arrays raise, as orbax refuses them.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, FrozenSet, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from devit_tpu_torch.io import ocdbt, zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
SHARDING = "_sharding"
ARRAY_METADATAS = os.path.join("array_metadatas", "process_0")
KEY_SEQUENCE, KEY_DICT = 1, 2
JAX_ARRAY, NP_ARRAY = "jax.Array", "np.ndarray"
_EMPTY = {"None": None, "NamedTuple": None, "Dict": {}, "List": {}, "Tuple": {}}
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_SINGLE_DEVICE = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
_ZARR_LEVEL = 1
_WORKERS = min(8, os.cpu_count() or 1)
_DTYPES = {np.dtype(t).str: np.dtype(t) for t in (
    np.float16, np.float32, np.float64, np.int8, np.int16, np.int32, np.int64,
    np.uint8, np.uint16, np.uint32, np.uint64, np.bool_)}


class Leaf(NamedTuple):
    """One leaf of a flattened tree: its keys, their key types, and the
    value (a host array, a numpy scalar, or an empty value)."""
    keys: Tuple[str, ...]
    key_types: Tuple[int, ...]
    value: Any


# ------------------------------------------------------------ the tree


def _is_sequence_dict(d: dict) -> bool:
    return set(d) == {str(i) for i in range(len(d))}


def flatten(tree: Any, keys=(), key_types=()) -> List[Leaf]:
    """The leaves of a tree of str-keyed dicts in orbax's order (dict keys
    sorted, a sequence's by index); an empty dict or None is a leaf of its
    own."""
    if isinstance(tree, dict) and tree:
        if _is_sequence_dict(tree):
            items = [(str(i), tree[str(i)]) for i in range(len(tree))]
            kt = KEY_SEQUENCE
        else:
            if not all(isinstance(k, str) for k in tree):
                raise TypeError(f"orbax checkpoint: non-str dict key under {keys}")
            items, kt = sorted(tree.items()), KEY_DICT
        return [leaf for k, v in items for leaf in flatten(v, keys + (k,), key_types + (kt,))]
    return [Leaf(keys, key_types, tree)]


def _host_copy(x):
    """A copy of leaf `x` on the host that no later in-place update of the
    caller's tensors reaches: the blocking part of an async save."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.numel() == 0:
            raise ValueError("orbax checkpoint: zero-size arrays cannot be saved (orbax "
                             "refuses them)")
        return t.to("cpu", non_blocking=True) if t.device.type != "cpu" else t.clone()
    if isinstance(x, np.ndarray):
        if x.size == 0:
            raise ValueError("orbax checkpoint: zero-size arrays cannot be saved (orbax "
                             "refuses them)")
        return np.array(x, copy=True, order="C")
    if isinstance(x, (np.generic, bool, int, float)):
        return np.asarray(x)[()]  # immutable: a numpy scalar
    if x is None or isinstance(x, dict):  # flatten leaves only empty dicts
        return x
    raise TypeError(f"orbax checkpoint: cannot save a leaf of type {type(x).__name__}")


def snapshot(tree: Any) -> List[Leaf]:
    """The flattened tree with every leaf copied to host memory (device
    tensors by one asynchronous copy each, then one synchronize)."""
    leaves = [Leaf(l.keys, l.key_types, _host_copy(l.value)) for l in flatten(tree)]
    if torch.cuda.is_available() and any(isinstance(l.value, torch.Tensor) for l in leaves):
        torch.cuda.synchronize()
    return leaves


def _name(keys) -> str:
    return ".".join(keys)


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray, np.generic))


def _value_metadata(v, device: bool) -> dict:
    if not _is_array(v):
        return {"value_type": "None", "skip_deserialize": True}  # None or an empty dict
    if device:
        return {"value_type": JAX_ARRAY, "skip_deserialize": False,
                "write_shape": list(v.shape)}
    return {"value_type": NP_ARRAY, "skip_deserialize": False}


def _as_numpy(v) -> Tuple[np.ndarray, str]:
    """The leaf's bytes as a C-contiguous numpy array, and its zarr dtype."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.contiguous().numpy()
    a = np.require(v, requirements="C")  # 0-d stays 0-d (ascontiguousarray makes it 1-d)
    if a.dtype.str not in _DTYPES:
        raise TypeError(f"orbax checkpoint: dtype {a.dtype} is not written")
    return a, a.dtype.str


def _zarray(shape, dtype: str) -> bytes:
    return json.dumps({"chunks": list(shape), "compressor": {"id": "zstd", "level": _ZARR_LEVEL},
                       "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                       "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2},
                      sort_keys=True, separators=(",", ":")).encode()


def _encode(leaf: Leaf) -> List[Tuple[str, bytes]]:
    a, dtype = _as_numpy(leaf.value)
    name = _name(leaf.keys)
    chunk = ".".join("0" for _ in a.shape) or "0"
    return [(f"{name}/.zarray", _zarray(a.shape, dtype)),
            (f"{name}/{chunk}", zstd.compress(a, _ZARR_LEVEL))]


def _items(arrays: List[Leaf]) -> Iterator[Tuple[str, bytes]]:
    """Each array leaf's zarr keys and values, compressed in threads (at
    most 2 * _WORKERS leaves ahead of the writer)."""
    with ThreadPoolExecutor(_WORKERS) as pool:
        pending = []
        for leaf in arrays:
            pending.append(pool.submit(_encode, leaf))
            if len(pending) > 2 * _WORKERS:
                yield from pending.pop(0).result()
        for fut in pending:
            yield from fut.result()


def _write_json(path: str, obj, **kw) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, **kw)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_checkpoint(path: str, leaves: List[Leaf],
                     device_state: FrozenSet[str] = frozenset()) -> None:
    """Write the snapshot `leaves` as an orbax checkpoint directory at
    `path`, the arrays under the top-level keys `device_state` recorded as
    jax.Arrays and the others as numpy arrays (see the module docstring):
    into a temporary sibling, every file fsynced, then renamed to
    `path` (which must not exist), so `path` is complete whenever it
    exists. A failed write removes its temporary directory."""
    if os.path.exists(path):
        raise FileExistsError(f"orbax checkpoint: {path!r} exists")
    t0 = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{t0}"
    os.makedirs(tmp)
    try:
        _write_into(tmp, leaves, device_state, t0)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _write_into(tmp: str, leaves: List[Leaf], device_state: FrozenSet[str], t0: int) -> None:
    arrays = [l for l in leaves if _is_array(l.value)]
    on_device = lambda l: bool(l.keys) and l.keys[0] in device_state
    names = [_name(l.keys) for l in arrays]
    if len(set(names)) != len(names):
        raise ValueError("orbax checkpoint: two leaves share a name (a key holds '.')")
    ocdbt.write_store(tmp, _items(arrays))
    tree_md = {}
    for l in leaves:
        tree_md[repr(tuple(l.keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in zip(l.keys, l.key_types)],
            "value_metadata": _value_metadata(l.value, on_device(l))}
    jax_arrays = [l for l in arrays if on_device(l)]
    _write_json(os.path.join(tmp, ARRAY_METADATAS), {"array_metadatas": [
        {"array_metadata": {"param_name": _name(l.keys), "write_shape": list(l.value.shape),
                            "chunk_shape": list(l.value.shape), "ext_metadata": None}}
        for l in jax_arrays]})
    _write_json(os.path.join(tmp, SHARDING),
                {base64.b64encode(_name(l.keys).encode()).decode(): _SINGLE_DEVICE
                 for l in jax_arrays}, separators=(",", ":"))
    _write_json(os.path.join(tmp, METADATA), {
        "tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(tmp, CHECKPOINT_METADATA), {
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}})
    for d in (tmp, os.path.join(tmp, "d"), os.path.join(tmp, ocdbt.PROCESS_DIR),
              os.path.join(tmp, ocdbt.PROCESS_DIR, "d"), os.path.dirname(
                  os.path.join(tmp, ARRAY_METADATAS))):
        _fsync_dir(d)


# ------------------------------------------------------------ reading


def _read_array(store: ocdbt.Store, name: str):
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')} (only 2 is read)")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: order {meta.get('order')!r} / filters "
                         f"{meta.get('filters')!r} are not read (C order, no filters)")
    comp = meta.get("compressor") or {}
    if comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} is not read (zstd only)")
    bf16 = meta["dtype"] == "bfloat16"
    if not bf16 and meta["dtype"] not in _DTYPES:
        raise ValueError(f"{name}: zarr dtype {meta['dtype']!r} is not read")
    dtype = np.dtype(np.uint16) if bf16 else _DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(str(i) for i in idx) or '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        whole = chunks == shape
        buf = out if whole else np.empty(chunks, dtype)
        # orbax stores every chunk (store_array_data_equal_to_fill_value)
        zstd.decompress_into(store.get(key), buf)
        if not whole:
            out[region] = buf[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def read_checkpoint(path: str) -> Any:
    """The raw tree of the orbax checkpoint directory `path` (see the
    module docstring for its layout)."""
    if not os.path.isfile(os.path.join(path, METADATA)):
        raise ValueError(f"{path!r} is not an orbax checkpoint directory (no {METADATA})")
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: only OCDBT + zarr v2 checkpoints are read (what the JAX "
                         "package writes)")
    tree_md = meta["tree_metadata"]
    store = ocdbt.Store(path)
    root: Dict[str, Any] = {}
    reads = []
    for entry in tree_md.values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        vm = entry["value_metadata"]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if not keys:
            raise ValueError(f"{path}: a tree_metadata entry with no keys")
        vt = vm.get("value_type")
        if vt in _EMPTY:
            node[keys[-1]] = None if _EMPTY[vt] is None else {}
        else:
            reads.append((node, keys[-1], _name(keys)))
    with ThreadPoolExecutor(_WORKERS) as pool:
        values = list(pool.map(lambda r: _read_array(store, r[2]), reads))
    for (node, key, _), v in zip(reads, values):
        node[key] = v
    return root

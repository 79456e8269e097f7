"""Checkpoint save/restore in the JAX package's msgpack format (counterpart
of devit_tpu/io/checkpoint.py:28-58, the msgpack part), over the port's own
msgpack codec (io/msgpack.py), so a file either package writes, the other
reads. Orbax checkpoint directories are not read yet: restore_pytree raises
on one.
"""

from __future__ import annotations

import os
from typing import Any

from devit_tpu_torch.io import msgpack


def save_pytree(path: str, tree: Any) -> None:
    """Atomic msgpack save, as flax.serialization.to_bytes writes the tree:
    write a temporary file, then os.replace, so a crash mid-write never
    truncates the previous good file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(msgpack.to_bytes(tree))
    os.replace(tmp, path)


def _orbax_dir(path: str) -> bool:
    """The JAX package's orbax layouts: a directory (or its '.new' promotion
    left by a crash), or a '.msgpack' name whose '.orbax' sibling is one."""
    if os.path.isdir(path) or os.path.isdir(path + ".new"):
        return True
    if not os.path.exists(path) and path.endswith(".msgpack"):
        sibling = path[: -len(".msgpack")] + ".orbax"
        return os.path.isdir(sibling) or os.path.isdir(sibling + ".new")
    return False


def restore_pytree(path: str) -> Any:
    """The raw tree of a msgpack checkpoint (flax's msgpack_restore: nested
    dicts, numpy leaves, bfloat16 as torch tensors, chunked arrays joined).
    Raises ValueError on an orbax checkpoint directory or malformed data,
    FileNotFoundError on a missing file."""
    if _orbax_dir(path):
        raise ValueError(f"{path!r} is an orbax checkpoint directory; the port reads "
                         "msgpack checkpoints only (orbax is not ported yet)")
    with open(path, "rb") as f:
        data = f.read()
    return msgpack.restore(data)

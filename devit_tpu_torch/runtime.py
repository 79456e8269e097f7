"""Process-wide setup for the entry points (counterpart of
devit_tpu/runtime.py).

The port runs in one process on one card: there is no compilation cache to
enable (nothing is compiled ahead of time but the CUDA kernels, which
kernels/_build.py caches by source hash) and no process group. Multi-process
training waits for ROADMAP Queue 1 item 8; an environment that asks for it
(DEVIT_MULTIHOST or DEVIT_COORDINATOR) raises instead of running one
process silently.
"""

from __future__ import annotations

import os

_DONE = False
MULTIHOST_VARS = ("DEVIT_MULTIHOST", "DEVIT_COORDINATOR")


def setup_runtime() -> None:
    """Idempotent. Raises where the environment asks for several processes."""
    global _DONE
    if _DONE:
        return
    asked = [v for v in MULTIHOST_VARS if os.environ.get(v)]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)} set: multi-process runs of the port wait for ROADMAP "
            "Queue 1 item 8 (torch.distributed); unset it to run one process on one card")
    _DONE = True


def is_main_process() -> bool:
    """True: the port runs one process (reference dist_utils.is_main_process).
    It gates the file artifacts, as in the JAX package."""
    return True

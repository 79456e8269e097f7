"""Process-wide setup for the entry points (counterpart of
devit_tpu/runtime.py): the multi-process rendezvous and the rank queries.

The port runs one process per device, as `torchrun` launches it. Nothing is
set up unless the environment asks for several processes:

- DEVIT_COORDINATOR=<host:port> with DEVIT_NUM_PROCESSES and
  DEVIT_PROCESS_ID: an explicit rendezvous at tcp://host:port (the JAX
  package's coordinator path);
- DEVIT_MULTIHOST=1: the launcher's variables, torchrun's (RANK, WORLD_SIZE,
  LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or SLURM's (SLURM_PROCID,
  SLURM_NTASKS, SLURM_LOCALID, with MASTER_ADDR/MASTER_PORT or
  DEVIT_COORDINATOR for the address), as the reference's
  dist_utils.init_distributed_mode reads them. Neither found raises. A
  torchrun launch of several processes (TORCHELASTIC_RUN_ID, WORLD_SIZE >
  1) counts as DEVIT_MULTIHOST=1: its ranks never run as W lone processes.

The backend is NCCL for a CUDA run and gloo for a CPU run. DEVIT_DIST_BACKEND
=gloo is the one override, for ranks that share a card (NCCL refuses two
ranks on one device, and a NCCL run whose local rank has no card of its own
raises naming the override). Nothing switches backend on its own.

After the rendezvous, parallel/mesh.py builds the process groups of the
'data' and 'div' axes, and device.resolve_device gives each rank
cuda:{local_rank % device_count}.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_DONE = False
_LOCAL_RANK = 0
BACKENDS = ("nccl", "gloo")


def setup_runtime(device: str = "cuda") -> None:
    """Idempotent. Joins the process group the environment asks for (see
    the module docstring), with the backend for `device` ('cuda' or
    'cpu')."""
    global _DONE
    if _DONE:
        return
    spec = _process_spec()
    if spec is not None:
        _init_process_group(*spec, device=device)
    _DONE = True


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def _process_spec():
    """(init_method, world_size, rank, local_rank) from the environment, or
    None where it asks for one process."""
    coord = os.environ.get("DEVIT_COORDINATOR")
    torchrun = "TORCHELASTIC_RUN_ID" in os.environ and (_env_int("WORLD_SIZE") or 1) > 1
    multihost = os.environ.get("DEVIT_MULTIHOST") == "1" or torchrun
    if not coord and not multihost:
        return None
    if coord and not multihost:
        world, rank = _env_int("DEVIT_NUM_PROCESSES"), _env_int("DEVIT_PROCESS_ID")
        if world is None or rank is None:
            raise RuntimeError("DEVIT_COORDINATOR needs DEVIT_NUM_PROCESSES and "
                               "DEVIT_PROCESS_ID")
        local = _env_int("LOCAL_RANK")
        return f"tcp://{coord}", world, rank, rank if local is None else local
    if _env_int("RANK") is not None and _env_int("WORLD_SIZE") is not None:
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        local = _env_int("LOCAL_RANK")
    elif _env_int("SLURM_PROCID") is not None:
        world, rank = _env_int("SLURM_NTASKS"), _env_int("SLURM_PROCID")
        local = _env_int("SLURM_LOCALID")
        if world is None:
            raise RuntimeError("DEVIT_MULTIHOST=1 under SLURM needs SLURM_NTASKS")
    else:
        raise RuntimeError("DEVIT_MULTIHOST=1 found neither torchrun's RANK/WORLD_SIZE nor "
                           "SLURM's SLURM_PROCID/SLURM_NTASKS; launch with torchrun or srun, "
                           "or set DEVIT_COORDINATOR, DEVIT_NUM_PROCESSES and "
                           "DEVIT_PROCESS_ID")
    if coord:
        addr = coord
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    else:
        raise RuntimeError("DEVIT_MULTIHOST=1 needs the rendezvous address: MASTER_ADDR and "
                           "MASTER_PORT (torchrun sets both) or DEVIT_COORDINATOR=host:port")
    return f"tcp://{addr}", world, rank, rank if local is None else local


def backend_for(device: str) -> str:
    """NCCL for CUDA, gloo for the CPU; DEVIT_DIST_BACKEND overrides."""
    want = os.environ.get("DEVIT_DIST_BACKEND")
    if want:
        if want not in BACKENDS:
            raise ValueError(f"DEVIT_DIST_BACKEND={want!r}: expected one of {BACKENDS}")
        if want == "nccl" and torch.device(device).type != "cuda":
            raise ValueError("DEVIT_DIST_BACKEND=nccl needs --device cuda")
        return want
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_process_group(init_method: str, world: int, rank: int, local: int, *,
                        device: str) -> None:
    global _LOCAL_RANK
    backend = backend_for(device)
    if backend == "nccl":
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(
                f"NCCL cannot run two ranks on one device: local rank {local} would share "
                f"cuda:{local % max(n, 1)} ({n} visible); launch at most one rank a card, or "
                "set DEVIT_DIST_BACKEND=gloo for ranks that share a card")
    _LOCAL_RANK = local
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def local_rank() -> int:
    return _LOCAL_RANK if distributed() else 0


def is_main_process() -> bool:
    """Rank 0 (reference dist_utils.is_main_process); True in one process.
    It gates the file artifacts (stats, result.txt, TensorBoard, checkpoints),
    as in the JAX package."""
    return rank() == 0


def shutdown() -> None:
    """Leave the process group (the launcher's workers call it last)."""
    global _DONE, _LOCAL_RANK
    if distributed():
        from devit_tpu_torch.parallel.mesh import forget_groups

        forget_groups()
        dist.destroy_process_group()
    _DONE, _LOCAL_RANK = False, 0

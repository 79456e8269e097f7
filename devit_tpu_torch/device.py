"""Device resolution shared by every entry point of the port.

The port runs on CUDA unless the caller asks for the CPU. A request for CUDA
on a machine without a usable card raises; nothing falls back to the CPU.
Under a process group (runtime.setup_runtime) a bare "cuda" is the rank's
own card, cuda:{local_rank % device_count}, made the current device.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda. Raises when cuda is asked for and absent. A bare cuda
    under a process group is the rank's card (module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        from devit_tpu_torch import runtime

        if runtime.distributed():
            dev = torch.device("cuda", runtime.local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(dev)
    return dev



def to_device(t: torch.Tensor, device: DeviceLike) -> torch.Tensor:
    """Copy a small host tensor (random draws made on the CPU) to `device`.
    On CUDA the copy is from pinned memory and does not block, so the host
    does not wait for the work already queued on the device."""
    dev = torch.device(device)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)

"""Multi-device collaborative serving (counterpart of
devit_tpu/parallel/serve.py): the deployment story of the paper.

In the reference each MultiViT backbone lives on its own edge device and
ships its C-wide cls/dist tokens to the fusion device (SURVEY.md §3.4). Here
every compact division lives on its own card (division d on
devices[d % len(devices)]) and runs there, through the attention kernel,
on that card's stream; CUDA launches return at once, so the divisions of
one batch run concurrently across cards. Only the (B, C) token pairs cross
cards, to the fusion device, where EnsMLP runs.

Fusion placement: on the first device that holds no division, else
devices[0]. Fusion needs only the current batch's tokens, so on a card of
its own it overlaps the divisions' next batches; `serve.stream(ens_vars,
batches, depth=2)` keeps `depth` batches in flight and copies each batch's
logits to the host `depth` batches behind, so nothing waits in between.

On one device the same code runs the divisions one after the other, the
fusion on that device: it is the forward of the serving engine
(serving/daemon.py) and of the stage-5 compact eval on every machine.
`serving_devices` picks the devices: every visible card for one process,
a rank's own card under several. Placement across several cards cannot
run on a one-card machine; its bookkeeping (`placement`) is tested on its
own.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from devit_tpu_torch.device import resolve_device
from devit_tpu_torch.models.compact_vit import CompactViT, stack_division_features
from devit_tpu_torch.runtime import world_size


def placement(num_divisions: int, devices: Sequence[torch.device],
              fusion_device: Optional[torch.device] = None
              ) -> Tuple[List[torch.device], torch.device]:
    """(division d's device for each d, the fusion device): divisions round
    robin over `devices`, fusion on the first spare one, else devices[0]."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("collaborative serving needs at least one device")
    if fusion_device is None:
        fusion_device = devices[num_divisions] if len(devices) > num_divisions else devices[0]
    return [devices[d % len(devices)] for d in range(num_divisions)], torch.device(fusion_device)


def local_devices() -> List[torch.device]:
    """Every card this process sees (raises where there is none)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def serving_devices(device: torch.device) -> List[torch.device]:
    """The devices a server on `device` places its divisions on: every
    visible card where one process serves on cuda, else `device` alone (a
    rank of a launch keeps to the card resolve_device gave it, as a JAX
    process sees only its own chips)."""
    device = torch.device(device)
    if device.type == "cuda" and world_size() == 1:
        return local_devices()
    return [device]


def make_collaborative_server(
    cms: Sequence[CompactViT],
    ens_apply: Callable,
    ens_vars,
    *,
    patch_size: int = 16,
    devices: Optional[Sequence[torch.device]] = None,
    fusion_device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.bfloat16,
    use_kernel: bool = True,
    fast_math: bool = True,
) -> Callable:
    """Build `serve(ens_vars, images) -> logits` (on the fusion device) with
    division d moved to devices[d % len(devices)] (the modules move in place)
    and EnsMLP fusion on `fusion_device` (placement()).

    ens_apply: (ens_vars, cls_stack, dist_stack) -> output with .logits, e.g.
    `lambda ev, c, t: functional_call(ens, ev, (c, t))`; `ens_vars` is a
    {name: tensor} dict, passed (possibly updated) on every call, the build
    argument only checks it. images: (B, H, W, 3) normalized, a tensor
    anywhere or a host array. devices: default every visible card.

    The returned callable also carries `serve.stream(ens_vars, batches,
    depth=2)`, a generator of host float32 logits per batch (module
    docstring), and the attributes division_devices, fusion_device and
    placed_divisions."""
    devices = local_devices() if devices is None else list(devices)
    div_devs, fusion_dev = placement(len(cms), devices, fusion_device)
    placed = [cm.to(dev) for cm, dev in zip(cms, div_devs)]
    if not isinstance(ens_vars, dict):
        raise TypeError("ens_vars: a {parameter name: tensor} dict (functional_call's)")

    def _on_fusion(ev):
        return {k: v.to(fusion_dev) for k, v in ev.items()}

    @torch.inference_mode()
    def _dispatch(ev, images) -> torch.Tensor:
        cls_stack, dist_stack = stack_division_features(
            placed, images, patch_size=patch_size, dtype=dtype, use_kernel=use_kernel,
            fast_math=fast_math, out_device=fusion_dev)
        return ens_apply(ev, cls_stack, dist_stack).logits

    def serve(ens_vars, images) -> torch.Tensor:
        return _dispatch(_on_fusion(ens_vars), images)

    def stream(ens_vars, batches: Iterable, *, depth: int = 2):
        """Yield host float32 logits per batch, in order, keeping up to
        `depth` batches in flight; batch k is copied to the host only after
        batches k+1..k+depth were launched. depth=1 is double buffering."""
        if depth < 1:
            raise ValueError(f"stream depth must be >= 1, got {depth}")
        ev = _on_fusion(ens_vars)
        inflight: deque = deque()
        for images in batches:
            inflight.append(_dispatch(ev, images))
            if len(inflight) > depth:
                yield _host(inflight.popleft())
        while inflight:
            yield _host(inflight.popleft())

    serve.stream = stream
    serve.division_devices = div_devs
    serve.fusion_device = fusion_dev
    serve.placed_divisions = placed
    return serve


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()

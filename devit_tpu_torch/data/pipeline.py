"""Input normalisation (counterpart of devit_tpu/data/pipeline.py:25-67).
The train-time augmentations come with the data slice."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8/float [0,255] NHWC -> standardized float (scaled by 1/255 once).

    Every division is by a tensor on the images' device: PyTorch's CUDA
    `tensor / python_scalar` multiplies by the reciprocal, which can be an ulp
    off the IEEE quotient that JAX (and the CPU) compute."""
    x = images.to(torch.float32)
    x = x / torch.tensor(255.0, dtype=torch.float32, device=x.device)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)

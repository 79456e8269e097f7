"""Token-fusion head of the collaborative ensemble (counterpart of
devit_tpu/models/ensemble.py:102-168).

Division tokens (D, B, C) are concatenated division-major per batch element,
optionally projected to `teacher_size`, then classified over the full label
set; the deit family averages separate cls/dist classifiers. Submodule names
are the flax ones (cls_mlp, cls_classifier, dist_mlp, dist_classifier), so
the weights carry across by name.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn


class EnsOutput(NamedTuple):
    logits: torch.Tensor
    cls_logits: Optional[torch.Tensor] = None
    dist_logits: Optional[torch.Tensor] = None


class Dense(nn.Module):
    """flax `nn.Dense(features, dtype=...)` at inference: input, kernel and
    bias are cast to the compute dtype, and the product and the bias add
    each round to it. Kernel in (in, out) layout."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features), requires_grad=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.matmul(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)

    def load(self, params: dict) -> "Dense":
        with torch.no_grad():
            for name in ("kernel", "bias"):
                src = torch.tensor(np.asarray(params[name], np.float32))
                dst = getattr(self, name)
                if src.shape != dst.shape:
                    raise ValueError(f"{name} shape {tuple(src.shape)} != "
                                     f"expected {tuple(dst.shape)}")
                dst.copy_(src)
        return self


class EnsMLP(nn.Module):
    """Fusion head over division tokens; serving forward only."""

    def __init__(self, num_classes: int = 100, sub_size: int = 384,
                 num_divisions: int = 4, teacher_size: Optional[int] = None,
                 family: str = "deit", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if family not in ("deit", "vit"):
            raise ValueError(f"family must be 'deit' or 'vit', got {family!r}")
        self.num_classes = num_classes
        self.sub_size = sub_size
        self.num_divisions = num_divisions
        self.teacher_size = teacher_size
        self.family = family
        self.dtype = dtype
        fused = num_divisions * sub_size
        width = teacher_size if teacher_size is not None else fused
        branches = ("cls", "dist") if family == "deit" else ("cls",)
        for b in branches:
            if teacher_size is not None:
                self.add_module(f"{b}_mlp", Dense(fused, teacher_size))
            self.add_module(f"{b}_classifier", Dense(width, num_classes))

    def _branch(self, name: str, tokens: torch.Tensor) -> torch.Tensor:
        D, B, C = tokens.shape
        # (D, B, C) -> (B, D*C), division-major
        x = tokens.transpose(0, 1).reshape(B, D * C).to(self.dtype)
        if self.teacher_size is not None:
            x = getattr(self, f"{name}_mlp")(x, self.dtype)
        return getattr(self, f"{name}_classifier")(x, self.dtype).float()

    def forward(self, cls_tokens: torch.Tensor,
                dist_tokens: Optional[torch.Tensor] = None) -> EnsOutput:
        cls_logits = self._branch("cls", cls_tokens)
        if self.family == "deit":
            if dist_tokens is None:
                raise ValueError("the deit family needs dist tokens")
            dist_logits = self._branch("dist", dist_tokens)
            return EnsOutput(logits=(cls_logits + dist_logits) / 2.0,
                             cls_logits=cls_logits, dist_logits=dist_logits)
        return EnsOutput(logits=cls_logits, cls_logits=cls_logits)

    def load_params(self, params: dict) -> "EnsMLP":
        """Load a flax EnsMLP `params` tree (nested dict of arrays)."""
        expected = {name for name, _ in self.named_children()}
        if set(params) != expected:
            raise ValueError(f"EnsMLP params have submodules {sorted(params)}, "
                             f"expected {sorted(expected)}")
        for name in expected:
            getattr(self, name).load(params[name])
        return self

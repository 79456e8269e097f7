"""Collaborative-inference ensemble: stacked division backbones and the
token-fusion head (counterpart of devit_tpu/models/ensemble.py), for the
ViT family (MultiViT + EnsMLP) and the CCT family (`multicct_features`,
`EnsembleCCT`: one pooled token a division).

The D divisions keep the JAX layout: one {parameter name: (D, ...) tensor}
dict, the port's names with a leading division axis (`stack_division_params`,
`init_multivit`). `multivit_features` runs each division through
torch.func.functional_call on its slice {k: v[d]}, in a loop over D that
takes the place of the JAX package's jax.vmap; gradients land on the stacked
leaves, so one optimizer state spans every division.

`EnsMLP` concatenates the division tokens (D, B, C) division-major per batch
element, optionally projects them to `teacher_size`, then classifies over
the full label set; the deit family averages separate cls/dist classifiers.
Submodule names are the flax ones (cls_mlp, cls_classifier, dist_mlp,
dist_classifier), so the weights carry across by name.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from devit_tpu_torch.models import vit
from devit_tpu_torch.models.vit import (
    Gates, Rows, VisionTransformer, _trunc_normal_, full_gates, train_draws,
)

# parameters a features_only forward never reaches; the JAX package's
# features_only init never creates them
_HEAD_MODULES = ("head", "head_dist")


class EnsOutput(NamedTuple):
    logits: torch.Tensor
    cls_logits: Optional[torch.Tensor] = None
    dist_logits: Optional[torch.Tensor] = None
    ens_tokens: Optional[Any] = None  # fused token(s) for the EnsLoss token matching


class Dense(vit.Dense):
    """flax `nn.Dense(features, dtype=...)` (models/vit.py's Dense, with a
    bias), loadable from a flax Dense `params` dict (numpy or torch leaves)."""

    def load(self, params: dict) -> "Dense":
        with torch.no_grad():
            for name in ("kernel", "bias"):
                src = params[name]
                src = (src.detach().float() if isinstance(src, torch.Tensor)
                       else torch.tensor(np.asarray(src, np.float32)))
                dst = getattr(self, name)
                if src.shape != dst.shape:
                    raise ValueError(f"{name} shape {tuple(src.shape)} != "
                                     f"expected {tuple(dst.shape)}")
                dst.copy_(src)
        return self


class EnsMLP(nn.Module):
    """Fusion head over division tokens (ensemble_models.py:43-90)."""

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

    def reset_parameters(self, generator: torch.Generator) -> "EnsMLP":
        """The JAX package's initializers: clip(0.02 normal, -2, 2) kernels
        and zero biases, drawn in parameter order from a CPU generator."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                with torch.no_grad():
                    p.zero_()
            else:
                _trunc_normal_(p, generator)
        return self

    def _branch(self, name: str, tokens: torch.Tensor):
        D, B, C = tokens.shape
        # (D, B, C) -> (B, D*C), division-major
        x = tokens.transpose(0, 1).reshape(B, D * C).to(self.dtype)
        if self.teacher_size is not None:
            x = getattr(self, f"{name}_mlp")(x, self.dtype)
        return x, getattr(self, f"{name}_classifier")(x, self.dtype).float()

    def forward(self, cls_tokens: torch.Tensor, dist_tokens: Optional[torch.Tensor] = None, *,
                distill: bool = False, train: bool = False) -> EnsOutput:
        """ens_tokens (the fused, projected tokens the EnsLoss matches with the
        teacher's) is set exactly when distill and train and teacher_size."""
        ens_cls, cls_logits = self._branch("cls", cls_tokens)
        if self.family == "deit":
            if dist_tokens is None:
                raise ValueError("the deit family needs dist tokens")
            ens_dist, dist_logits = self._branch("dist", dist_tokens)
            logits = (cls_logits + dist_logits) / 2.0
            ens_tokens = (ens_cls, ens_dist)
        else:
            logits, dist_logits, ens_tokens = cls_logits, None, ens_cls
        want_tokens = distill and train and self.teacher_size is not None
        return EnsOutput(logits=logits, cls_logits=cls_logits, dist_logits=dist_logits,
                         ens_tokens=ens_tokens if want_tokens else None)

    def load_params(self, params: dict) -> "EnsMLP":
        """Load a flax EnsMLP `params` tree (nested dict of arrays)."""
        expected = {name for name, _ in self.named_children()}
        if set(params) != expected:
            raise ValueError(f"EnsMLP params have submodules {sorted(params)}, "
                             f"expected {sorted(expected)}")
        for name in expected:
            getattr(self, name).load(params[name])
        return self


def features_param_names(model: VisionTransformer) -> list:
    """Names of the parameters a features_only forward uses: every one but
    the classifier heads."""
    return [k for k, _ in model.named_parameters() if k.split(".")[0] not in _HEAD_MODULES]


def stack_division_params(params_list: Sequence[Mapping[str, torch.Tensor]]) -> dict:
    """Per-division {name: tensor} dicts -> one {name: (D, ...)} dict of
    trainable f32 leaves."""
    return {k: nn.Parameter(torch.stack([p[k].detach() for p in params_list]))
            for k in params_list[0]}


def stack_division_gates(gates_list: Sequence[Gates]) -> Gates:
    return Gates(head=torch.stack([torch.as_tensor(g.head) for g in gates_list]),
                 neuron=torch.stack([torch.as_tensor(g.neuron) for g in gates_list]))


def init_multivit(model: VisionTransformer, generators: Sequence[torch.Generator]) -> dict:
    """One division per generator, each drawn with the model's initializers
    (VisionTransformer.reset_parameters) -> the stacked features-only
    parameters, on the model's device. The model itself is left as it was."""
    names = features_param_names(model)
    divisions = []
    for gen in generators:
        params = dict(copy.deepcopy(model).reset_parameters(gen).named_parameters())
        divisions.append({k: params[k] for k in names})
    return stack_division_params(divisions)


def multivit_features(model: VisionTransformer, stacked_params: Mapping[str, torch.Tensor],
                      x: torch.Tensor, stacked_gates: Optional[Gates] = None, *,
                      train: bool = False, generator: Optional[torch.Generator] = None,
                      divisions: Optional[Sequence[int]] = None,
                      num_divisions: Optional[int] = None, rows: Optional[Rows] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All-division forward on the same batch (ensemble_models.py:32-40):
    division d runs `model` on stacked_params[k][d] with stacked_gates[d]
    (full gates if None). train=True enables the backbones' drop-path and
    dropout, drawn from `generator` one division after the other.

    A division-parallel rank holds some of the num_divisions divisions:
    `divisions` names the global index of each stacked slice, and the
    generator passes over the others' draws in order. `rows` (start, stop,
    global batch): x holds those rows (vit.VisionTransformer.forward).

    Returns (cls_tokens (D, B, C), dist_tokens (D, B, C) or None) over the
    stacked slices."""
    if train and generator is None:
        raise ValueError("multivit_features(train=True) needs generator= for the backbones' "
                         "dropout/drop-path draws")
    D = next(iter(stacked_params.values())).shape[0]
    divisions = list(range(D)) if divisions is None else list(divisions)
    num_divisions = D if num_divisions is None else num_divisions
    batch = x.shape[0] if rows is None else rows[2]
    cls_t, dist_t = [], []
    for g in range(num_divisions):
        if g not in divisions:
            if train:
                train_draws(model.cfg, generator, batch)
            continue
        d = divisions.index(g)
        gates = (full_gates(model.cfg, device=x.device) if stacked_gates is None
                 else Gates(head=stacked_gates.head[d], neuron=stacked_gates.neuron[d]))
        out = functional_call(model, {k: v[d] for k, v in stacked_params.items()}, (x,),
                              dict(gates=gates, features_only=True, train=train,
                                   generator=generator, rows=rows))
        cls_t.append(out.cls_feat)
        dist_t.append(out.dist_feat)
    return torch.stack(cls_t), (None if dist_t[0] is None else torch.stack(dist_t))


def ensemble_forward(model: VisionTransformer, ens_model: EnsMLP,
                     stacked_params: Mapping[str, torch.Tensor],
                     ens_params: Optional[Mapping[str, torch.Tensor]], x: torch.Tensor,
                     stacked_gates: Optional[Gates] = None, *, distill: bool = False,
                     train: bool = False, generator: Optional[torch.Generator] = None
                     ) -> EnsOutput:
    """The full collaborative path: MultiViT -> EnsMLP (engine.py:213-242).
    ens_params None runs ens_model's own parameters."""
    cls_t, dist_t = multivit_features(model, stacked_params, x, stacked_gates, train=train,
                                      generator=generator)
    kw = dict(distill=distill, train=train)
    if ens_params is None:
        return ens_model(cls_t, dist_t, **kw)
    return functional_call(ens_model, dict(ens_params), (cls_t, dist_t), kw)


def multicct_features(model, stacked_params: Mapping[str, torch.Tensor], x: torch.Tensor,
                      stacked_gates: Optional[Gates] = None, *, train: bool = False,
                      generators: Optional[Sequence[torch.Generator]] = None,
                      divisions: Optional[Sequence[int]] = None,
                      num_divisions: Optional[int] = None,
                      rows: Optional[Rows] = None) -> torch.Tensor:
    """All-division CCT backbone forward -> pooled features (D, B, C)
    (MultiCCT, ensemble_models.py:93-113): division d runs `model` (a CCT
    backbone) on stacked_params[k][d] with stacked_gates[d] (full gates if
    None). train=True enables the backbones' dropout and drop-path, one
    generator a division (the JAX package splits one key per division).
    `divisions`, `num_divisions` and `rows` as in multivit_features: a
    division-parallel rank runs the stacked slices it holds, each with the
    generator of its global index."""
    D = next(iter(stacked_params.values())).shape[0]
    divisions = list(range(D)) if divisions is None else list(divisions)
    num_divisions = D if num_divisions is None else num_divisions
    if train and (generators is None or len(generators) != num_divisions):
        raise ValueError("multicct_features(train=True) needs one generator a division for "
                         "the backbones' dropout/drop-path draws")
    feats = []
    for d, g in enumerate(divisions):
        gates = (full_gates(model.cfg, device=x.device) if stacked_gates is None
                 else Gates(head=stacked_gates.head[d], neuron=stacked_gates.neuron[d]))
        out = functional_call(model, {k: v[d] for k, v in stacked_params.items()}, (x,),
                              dict(gates=gates, train=train,
                                   generator=generators[g] if train else None, rows=rows))
        feats.append(out.pooled)
    return torch.stack(feats)


class EnsembleCCT(nn.Module):
    """CCT fusion head (ensemble_models.py:116-151): the division tokens (D,
    B, C) concatenated division-major, projected to teacher_size where set
    (cls_mlp), then classified (cls_classifier). Structurally EnsMLP's 'vit'
    path, kept as its own class for name parity."""

    def __init__(self, num_classes: int = 100, sub_size: int = 256, num_divisions: int = 4,
                 teacher_size: Optional[int] = None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.sub_size = sub_size
        self.num_divisions = num_divisions
        self.teacher_size = teacher_size
        self.dtype = dtype
        fused = num_divisions * sub_size
        if teacher_size is not None:
            self.cls_mlp = Dense(fused, teacher_size)
        self.cls_classifier = Dense(teacher_size if teacher_size is not None else fused,
                                    num_classes)

    reset_parameters = EnsMLP.reset_parameters
    load_params = EnsMLP.load_params

    def forward(self, features: torch.Tensor, *, distill: bool = False,
                train: bool = False) -> EnsOutput:
        D, B, C = features.shape
        fused = features.transpose(0, 1).reshape(B, D * C).to(self.dtype)
        if self.teacher_size is not None:
            fused = self.cls_mlp(fused, self.dtype)
        logits = self.cls_classifier(fused, self.dtype).float()
        tokens = fused if distill and train and self.teacher_size is not None else None
        return EnsOutput(logits=logits, cls_logits=logits, ens_tokens=tokens)

"""Train and eval steps (counterpart of devit_tpu/train/steps.py:38-147):
eval_counters, make_eval_step and the stage-2 sub-model step with every
distillation mode. The DEKD and ensemble steps come with their slices.

`variables` arguments are None (the module's own parameters) or a
{parameter name: tensor} dict run through torch.func.functional_call (for
example the EMA copy), the counterpart of `model.apply(variables, ...)`.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch.func import functional_call

from devit_tpu_torch.data.mixup import MixupConfig, mixup_cutmix
from devit_tpu_torch.models.vit import Gates, VisionTransformer
from devit_tpu_torch.train import losses as L
from devit_tpu_torch.train.state import TrainState


def _apply(model: torch.nn.Module, variables: Optional[Mapping[str, torch.Tensor]], *args,
           **kwargs):
    if variables is None:
        return model(*args, **kwargs)
    return functional_call(model, dict(variables), args, kwargs)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def eval_counters(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """Summed CE loss + top-1/top-5 correct counts for one batch. Rows with
    label < 0 are padding (run_eval pads the tail batch) and count nowhere."""
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    pred5 = torch.topk(logits, min(5, logits.shape[-1]), dim=-1).indices
    hit = (pred5 == safe[:, None]) & valid[:, None]
    return {
        "loss_sum": torch.where(valid, nll, torch.zeros_like(nll)).sum(),
        "top1": hit[:, 0].sum(),
        "top5": hit.any(dim=-1).sum(),
        "count": valid.sum(),
    }


def make_eval_step(model: VisionTransformer):
    """step(variables, gates, images, labels) -> summed counters. Kernel
    selection (use_kernel) lives on the model instance."""

    @torch.no_grad()
    def step(variables, gates: Optional[Gates], images, labels):
        dev = _device_of(model)
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        out = _apply(model, variables, images, gates=gates)
        return eval_counters(out.logits, labels)

    return step


def make_stage2_step(
    model: VisionTransformer,
    teacher_model: Optional[VisionTransformer] = None,
    *,
    mixup: Optional[MixupConfig] = None,
    smoothing: float = 0.1,
    distillation_type: str = "none",
    distillation_alpha: float = 0.5,
    distillation_tau: float = 1.0,
    distill_token: bool = False,
):
    """Sub-model finetune step (train_subdata.py:233-287).

    step(state, teacher_variables, images, labels, generator) -> (state,
    metrics). `state` holds `model`'s own parameters (TrainState.create
    (model, ...)) and is updated in place. `generator` draws the mixup
    parameters and the drop-path masks on its own device (the CPU: a few
    scalars and one (depth, 2, B) mask tensor per step). Metrics are device
    tensors, so the caller decides when to wait for them."""
    if distillation_type != "none" and teacher_model is None:
        raise ValueError(f"distillation_type={distillation_type!r} requires a teacher "
                         "model (--teacher-path)")
    mixup_active = mixup is not None and mixup.active
    base_criterion = L.make_base_criterion(mixup_active, smoothing)

    def step(state: TrainState, teacher_variables, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator):
        if mixup_active:
            images_m, targets = mixup_cutmix(generator, images, labels, mixup)
        else:
            images_m, targets = images, labels

        teacher_logits = teacher_token = None
        if distillation_type != "none":
            with torch.no_grad():
                t_out = _apply(teacher_model, teacher_variables, images_m,
                               distill_token=distill_token)
            teacher_logits, teacher_token = t_out.logits, t_out.last_tokens

        out = model(images_m, train=True, generator=generator, distill_token=distill_token)
        cls_logits = out.cls_logits
        kd_logits = out.dist_logits if out.dist_logits is not None else out.cls_logits
        base = base_criterion(cls_logits, targets)
        metrics = {}
        if distillation_type == "none":
            loss = base
        else:
            kd = L.cls_distill_loss(kd_logits, teacher_logits, distillation_type,
                                    distillation_tau)
            loss = base * (1 - distillation_alpha) + kd * distillation_alpha
            if distill_token:
                s_tok, t_tok = out.last_tokens, teacher_token
                if isinstance(s_tok, tuple):
                    token_loss = L.mse_loss(s_tok[0], t_tok[0]) + L.mse_loss(s_tok[1], t_tok[1])
                else:
                    token_loss = L.mse_loss(s_tok, t_tok)
                metrics["cls_loss"] = loss
                metrics["token_loss"] = token_loss
                loss = loss + token_loss
        metrics["loss"] = loss

        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names], allow_unused=True)
        # a parameter the loss does not reach (e.g. resize heads) gets a zero
        # gradient, as jax.grad gives it: AdamW still decays it
        state.apply_gradients({k: torch.zeros_like(state.params[k]) if g is None else g
                               for k, g in zip(names, grads)})
        return state, {k: v.detach() for k, v in metrics.items()}

    return step

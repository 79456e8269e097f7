"""Train and eval steps (counterpart of devit_tpu/train/steps.py:38-317):
eval_counters, make_eval_step, the stage-2 sub-model step, the stage-4 DEKD
step and the stage-5 ensemble train and eval steps, with every distillation
mode. The CCT ensemble steps come with their slice.

`variables` arguments are None (the module's own parameters) or a
{parameter name: tensor} dict run through torch.func.functional_call (for
example the EMA copy), the counterpart of `model.apply(variables, ...)`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from devit_tpu_torch.data.mixup import MixupConfig, mixup_cutmix
from devit_tpu_torch.models.ensemble import EnsMLP, multivit_features
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


def _on(gates: Optional[Gates], device: torch.device) -> Optional[Gates]:
    if gates is None:
        return None
    return Gates(*(torch.as_tensor(t, device=device) for t in gates))


def _mix(mixup_active: bool, mixup: Optional[MixupConfig], generator, images, labels):
    if mixup_active:
        return mixup_cutmix(generator, images, labels, mixup)
    return images, labels


def _grads(loss: torch.Tensor, states: Sequence[TrainState]) -> list:
    """d loss / d params of each state, in one backward pass. A parameter the
    loss does not reach (e.g. resize heads) gets a zero gradient, as jax.grad
    gives it: AdamW still decays it."""
    leaves = [p for st in states for p in st.params.values()]
    flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    out = []
    for st in states:
        grads = {}
        for k, p in st.params.items():
            g = next(flat)
            grads[k] = torch.zeros_like(p) if g is None else g
        out.append(grads)
    return out


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
        images_m, targets = _mix(mixup_active, mixup, generator, images, labels)

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

        (grads,) = _grads(loss, [state])
        state.apply_gradients(grads)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_dekd_step(
    student: VisionTransformer,
    teacher: VisionTransformer,
    *,
    gamma: Tuple[float, float, float] = (0.2, 0.1, 0.3),
    mixup: Optional[MixupConfig] = None,
    smoothing: float = 0.1,
    distillation_type: str = "hard",
    distillation_alpha: float = 0.5,
    distillation_tau: float = 1.0,
    distillation_inter: bool = True,
):
    """DEKD step (engine.train_1epoch_qkv, engine.py:48-140): student forward
    with the middle layer's q/k/v captured, the teacher's forward under
    no_grad ditto, cls distillation plus the per-Q/K/V relation losses
    weighted by gamma.

    step(state, teacher_variables, gates, images, labels, generator) ->
    (state, metrics); the shrink gates apply to the student. The captured
    middle layer runs the plain attention and every other layer the kernels
    (the JAX package's scanned blocks take the plain attention in all of
    them). distillation_inter=False drops the relation losses and the
    captures (loss = cls distillation only), and every layer runs the
    kernels."""
    mixup_active = mixup is not None and mixup.active
    base_criterion = L.make_base_criterion(mixup_active, smoothing)
    capture = "middle" if distillation_inter else "none"

    def step(state: TrainState, teacher_variables, gates: Gates, images: torch.Tensor,
             labels: torch.Tensor, generator: torch.Generator):
        images_m, targets = _mix(mixup_active, mixup, generator, images, labels)
        with torch.no_grad():
            t_out = _apply(teacher, teacher_variables, images_m, capture_qkv=capture)
        out = student(images_m, gates=_on(gates, images_m.device), train=True,
                      generator=generator, capture_qkv=capture)
        kd_logits = out.dist_logits if out.dist_logits is not None else out.cls_logits
        if distillation_inter:
            total, aux = L.dekd_loss(
                (out.cls_logits, kd_logits), out.qkv, t_out.logits, t_out.qkv, targets,
                base_criterion, depth=student.cfg.depth, gamma=gamma,
                distillation_type=distillation_type, alpha=distillation_alpha,
                tau=distillation_tau)
        else:
            cls = L.distill_loss(out.cls_logits, kd_logits, t_out.logits, targets,
                                 base_criterion, distillation_type, distillation_alpha,
                                 distillation_tau)
            total, aux = cls, {"cls_loss": cls}
        aux["loss"] = total
        (grads,) = _grads(total, [state])
        state.apply_gradients(grads)
        return state, {k: v.detach() for k, v in aux.items()}

    return step


def make_ensemble_train_step(
    backbone: VisionTransformer,
    ens_model: EnsMLP,
    teacher: Optional[VisionTransformer] = None,
    *,
    mixup: Optional[MixupConfig] = None,
    smoothing: float = 0.1,
    distillation_type: str = "hard",
    distillation_alpha: float = 0.5,
    distillation_tau: float = 1.0,
    token_loss_type: str = "mse",
):
    """Ensemble step (engine.train_1epoch_ens_disjoint, engine.py:143-210):
    MultiViT features -> EnsMLP fusion -> EnsLoss, ONE backward through both,
    the gradients split between two optimizers: backbone_state over the
    stacked division parameters (all D in one state, so the global-norm clip
    and the EMA span every division, as in JAX), ens_state over ens_model's
    own parameters.

    step(backbone_state, ens_state, teacher_variables, stacked_gates, images,
    labels, generator) -> (backbone_state, ens_state, metrics); both states
    are updated in place. The backbones train with their drop-path active
    (engine.py:146)."""
    if distillation_type != "none":
        if teacher is None:
            raise ValueError(f"distillation_type={distillation_type!r} requires a teacher "
                             "model (--teacher-path)")
        if getattr(ens_model, "teacher_size", None) is None:
            raise ValueError("ensemble distillation requires EnsMLP(teacher_size=...) so "
                             "the fused tokens are projected for the token loss")
    mixup_active = mixup is not None and mixup.active
    base_criterion = L.make_base_criterion(mixup_active, smoothing)
    family = "deit" if backbone.cfg.distilled else "vit"

    def step(backbone_state: TrainState, ens_state: TrainState, teacher_variables,
             stacked_gates: Optional[Gates], images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator):
        images_m, targets = _mix(mixup_active, mixup, generator, images, labels)
        tea_logits = tea_tokens = None
        if distillation_type != "none":
            with torch.no_grad():
                t_out = _apply(teacher, teacher_variables, images_m, distill_token=True)
            tea_logits, tea_tokens = t_out.logits, t_out.last_tokens

        cls_t, dist_t = multivit_features(backbone, backbone_state.params, images_m,
                                          _on(stacked_gates, images_m.device), train=True,
                                          generator=generator)
        ens_out = ens_model(cls_t, dist_t, distill=True, train=True)
        if distillation_type == "none":
            loss = base_criterion(ens_out.logits, targets)
            metrics = {"loss": loss}
        else:
            token_loss, cls_loss = L.ens_loss(
                ens_out.ens_tokens, ens_out.logits, tea_tokens, tea_logits, targets,
                base_criterion, model_family=family, distillation_type=distillation_type,
                alpha=distillation_alpha, tau=distillation_tau, token_loss_type=token_loss_type)
            loss = token_loss + cls_loss  # engine.py:176
            metrics = {"loss": loss, "token_loss": token_loss, "cls_loss": cls_loss}
        bb_grads, ens_grads = _grads(loss, [backbone_state, ens_state])
        backbone_state.apply_gradients(bb_grads)
        ens_state.apply_gradients(ens_grads)
        return backbone_state, ens_state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_ensemble_eval_step(backbone: VisionTransformer, ens_model: EnsMLP):
    """Collaborative-inference eval (engine.evaluate_ens_disjoint,
    engine.py:212-242): step(stacked_params, ens_variables, stacked_gates,
    images, labels) -> summed counters."""

    @torch.no_grad()
    def step(stacked_params, ens_variables, stacked_gates: Optional[Gates], images, labels):
        dev = _device_of(ens_model)
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        cls_t, dist_t = multivit_features(backbone, stacked_params, images,
                                          _on(stacked_gates, dev))
        out = _apply(ens_model, ens_variables, cls_t, dist_t)
        return eval_counters(out.logits, labels)

    return step

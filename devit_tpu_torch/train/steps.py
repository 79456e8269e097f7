"""Train and eval steps (counterpart of devit_tpu/train/steps.py):
eval_counters, make_eval_step, the stage-2 sub-model step, the stage-4 DEKD
step and the stage-5 ensemble train and eval steps, with every distillation
mode, for the ViT family and (stage 5) the CCT family. The stage-2, DEKD
and eval steps take a CCT student or teacher unchanged (CCTOutput has the
cls_logits, dist_logits and last_tokens they read).

`variables` arguments are None (the module's own parameters) or a
{parameter name: tensor} dict run through torch.func.functional_call (for
example the EMA copy), the counterpart of `model.apply(variables, ...)`.

Every step takes an optional `layout` (parallel/mesh.Layout): each rank
then takes the global batch one process would take, mixes it whole (the
flip pairs row i with row B-1-i, which may lie on another rank), keeps its
rows, draws every per-sample random number at the global batch
(VisionTransformer.forward's `rows`), averages each state's gradients and
the loss metrics over the data group in one bucket per state, and, in stage
5, computes its own divisions and gathers the division tokens over the
division group. The eval steps sum their counters over the data group. A
W-rank step is the one-process step on the same global batch.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from devit_tpu_torch import tracing
from devit_tpu_torch.data.mixup import MixupConfig, mixup_cutmix
from devit_tpu_torch.models.ensemble import EnsMLP, multicct_features, multivit_features
from devit_tpu_torch.models.vit import Gates, VisionTransformer
from devit_tpu_torch.parallel.mesh import Layout, batch_rows
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


def _traced_step(step):
    """`step` inside the span "step" keyed by its train state's (first
    argument's) step count: the parent of the step.* spans below."""
    @functools.wraps(step)
    def traced(state, *args, **kwargs):
        with tracing.span("step", key=state.step):
            return step(state, *args, **kwargs)
    return traced


def _mix(mixup_active: bool, mixup: Optional[MixupConfig], generator, images, labels):
    with tracing.span("step.mix", device=True):
        if mixup_active:
            return mixup_cutmix(generator, images, labels, mixup)
        return images, labels


def _rows(layout: Optional[Layout], batch: int):
    return None if layout is None else layout.rows(batch)


def _mean_over_data(layout: Optional[Layout], grads: list, metrics: dict):
    """Each state's gradients averaged over the data group, one flattened
    bucket a state; the loss metrics ride in the last one."""
    if layout is None or layout.data_group is None:
        return grads, metrics
    names = list(metrics)
    out = []
    for i, g in enumerate(grads):
        keys = list(g)
        extra = ([metrics[k].detach().float().reshape(1) for k in names]
                 if i == len(grads) - 1 else [])
        vals = layout.mean_over_data([g[k] for k in keys] + extra)
        out.append(dict(zip(keys, vals[:len(keys)])))
        if extra:
            metrics = {k: v.reshape(()) for k, v in zip(names, vals[len(keys):])}
    return out, metrics


def _sum_counters(layout: Optional[Layout], rows, counters: dict) -> dict:
    """Counters summed over the data group, where the rank counted its rows
    only (a batch computed whole on every rank counts once)."""
    if layout is None or rows is None:
        return counters
    names = list(counters)
    flat = layout.sum_over_data(torch.stack([counters[k].double() for k in names]))
    return {k: flat[i].to(counters[k].dtype) for i, k in enumerate(names)}


def _backward(layout: Optional[Layout], loss: torch.Tensor, states: Sequence[TrainState],
              metrics: dict):
    """_grads, then _mean_over_data: the span step.backward covers the
    backward pass (remat's recompute included), the zero gradients and the
    mean over the data group."""
    with tracing.span("step.backward", device=True):
        return _mean_over_data(layout, _grads(loss, states), metrics)


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


def make_eval_step(model: VisionTransformer, layout: Optional[Layout] = None):
    """step(variables, gates, images, labels) -> summed counters (over the
    data group under `layout`). Kernel selection (use_kernel) lives on the
    model instance."""

    @torch.no_grad()
    def step(variables, gates: Optional[Gates], images, labels):
        dev = _device_of(model)
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        rows = _rows(layout, images.shape[0])
        images, labels = batch_rows(rows, images, labels)
        out = _apply(model, variables, images, gates=gates)
        return _sum_counters(layout, rows, eval_counters(out.logits, labels))

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
    layout: Optional[Layout] = None,
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

    @_traced_step
    def step(state: TrainState, teacher_variables, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator):
        images_m, targets = _mix(mixup_active, mixup, generator, images, labels)
        rows = _rows(layout, images_m.shape[0])
        images_m, targets = batch_rows(rows, images_m, targets)

        with tracing.span("step.forward", device=True):
            teacher_logits = teacher_token = None
            if distillation_type != "none":
                with torch.no_grad():
                    t_out = _apply(teacher_model, teacher_variables, images_m,
                                   distill_token=distill_token)
                teacher_logits, teacher_token = t_out.logits, t_out.last_tokens

            out = model(images_m, train=True, generator=generator, distill_token=distill_token,
                        rows=rows)
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
                        token_loss = (L.mse_loss(s_tok[0], t_tok[0])
                                      + L.mse_loss(s_tok[1], t_tok[1]))
                    else:
                        token_loss = L.mse_loss(s_tok, t_tok)
                    metrics["cls_loss"] = loss
                    metrics["token_loss"] = token_loss
                    loss = loss + token_loss
            metrics["loss"] = loss

        (grads,), metrics = _backward(layout, loss, [state], metrics)
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
    layout: Optional[Layout] = None,
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

    @_traced_step
    def step(state: TrainState, teacher_variables, gates: Gates, images: torch.Tensor,
             labels: torch.Tensor, generator: torch.Generator):
        images_m, targets = _mix(mixup_active, mixup, generator, images, labels)
        rows = _rows(layout, images_m.shape[0])
        images_m, targets = batch_rows(rows, images_m, targets)
        with tracing.span("step.forward", device=True):
            with torch.no_grad():
                t_out = _apply(teacher, teacher_variables, images_m, capture_qkv=capture)
            out = student(images_m, gates=_on(gates, images_m.device), train=True,
                          generator=generator, capture_qkv=capture, rows=rows)
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
        (grads,), aux = _backward(layout, total, [state], aux)
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
    layout: Optional[Layout] = None,
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
    (engine.py:146). Under a division-sharded `layout` backbone_state and
    stacked_gates hold this rank's divisions (parallel/mesh.shard_state)."""
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

    @_traced_step
    def step(backbone_state: TrainState, ens_state: TrainState, teacher_variables,
             stacked_gates: Optional[Gates], images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator):
        images_m, targets = _mix(mixup_active, mixup, generator, images, labels)
        rows = _rows(layout, images_m.shape[0])
        images_m, targets = batch_rows(rows, images_m, targets)
        with tracing.span("step.forward", device=True):
            tea_logits = tea_tokens = None
            if distillation_type != "none":
                with torch.no_grad():
                    t_out = _apply(teacher, teacher_variables, images_m, distill_token=True)
                tea_logits, tea_tokens = t_out.logits, t_out.last_tokens

            cls_t, dist_t = _division_tokens(
                layout, multivit_features, backbone, backbone_state.params, images_m,
                _on(stacked_gates, images_m.device), train=True, generator=generator, rows=rows)
            ens_out = ens_model(cls_t, dist_t, distill=True, train=True)
            if distillation_type == "none":
                loss = base_criterion(ens_out.logits, targets)
                metrics = {"loss": loss}
            else:
                token_loss, cls_loss = L.ens_loss(
                    ens_out.ens_tokens, ens_out.logits, tea_tokens, tea_logits, targets,
                    base_criterion, model_family=family, distillation_type=distillation_type,
                    alpha=distillation_alpha, tau=distillation_tau,
                    token_loss_type=token_loss_type)
                loss = token_loss + cls_loss  # engine.py:176
                metrics = {"loss": loss, "token_loss": token_loss, "cls_loss": cls_loss}
        (bb_grads, ens_grads), metrics = _backward(
            layout, loss, [backbone_state, ens_state], metrics)
        backbone_state.apply_gradients(bb_grads)
        ens_state.apply_gradients(ens_grads)
        return backbone_state, ens_state, {k: v.detach() for k, v in metrics.items()}

    return step


def _division_tokens(layout: Optional[Layout], features_fn, model, stacked_params, images,
                     gates, **kw):
    """features_fn's division tokens, computed for this rank's divisions and
    gathered over the division group under a division-sharded layout."""
    if layout is None or not layout.division_sharded:
        return features_fn(model, stacked_params, images, gates, **kw)
    out = features_fn(model, stacked_params, images, gates, divisions=layout.divisions,
                      num_divisions=layout.num_divisions, **kw)
    if isinstance(out, tuple):
        return tuple(None if t is None else layout.gather_divisions(t) for t in out)
    return layout.gather_divisions(out)


def make_ensemble_eval_step(backbone: VisionTransformer, ens_model: EnsMLP,
                            layout: Optional[Layout] = None):
    """Collaborative-inference eval (engine.evaluate_ens_disjoint,
    engine.py:212-242): step(stacked_params, ens_variables, stacked_gates,
    images, labels) -> summed counters (over the data group under
    `layout`)."""

    @torch.no_grad()
    def step(stacked_params, ens_variables, stacked_gates: Optional[Gates], images, labels):
        dev = _device_of(ens_model)
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        rows = _rows(layout, images.shape[0])
        images, labels = batch_rows(rows, images, labels)
        cls_t, dist_t = _division_tokens(layout, multivit_features, backbone, stacked_params,
                                         images, _on(stacked_gates, dev), rows=rows)
        out = _apply(ens_model, ens_variables, cls_t, dist_t)
        return _sum_counters(layout, rows, eval_counters(out.logits, labels))

    return step


# ---- stage 5, the CCT family


def make_cct_ensemble_train_step(
    backbone,
    ens_model,
    teacher=None,
    *,
    mixup: Optional[MixupConfig] = None,
    smoothing: float = 0.1,
    distillation_type: str = "none",
    distillation_alpha: float = 0.5,
    distillation_tau: float = 1.0,
    token_loss_type: str = "mse",
    layout: Optional[Layout] = None,
):
    """CCT collaborative-ensemble step (MultiCCT + EnsembleCCT,
    ensemble_models.py:93-151): one pooled token a division, the 'vit'
    EnsLoss (one token, one classifier), one backward through both, two
    optimizers as make_ensemble_train_step.

    step(backbone_state, ens_state, teacher_variables, stacked_gates, images,
    labels, generator) -> (backbone_state, ens_state, metrics): `generator`
    draws the mixup parameters, then one seed a division for that division's
    dropout and drop-path generator. `layout` as in make_ensemble_train_step."""
    if distillation_type != "none":
        from devit_tpu_torch.models.cct import CCT

        if teacher is None:
            raise ValueError(f"distillation_type={distillation_type!r} requires a teacher "
                             "model (--teacher-path)")
        if not isinstance(teacher, CCT):
            # the token loss reads the teacher's pooled feature, which a ViT
            # teacher (the CLI default) does not have
            raise ValueError("CCT ensemble distillation requires a CCT teacher "
                             f"(--teacher-model cct_*); got {type(teacher).__name__}")
        if getattr(ens_model, "teacher_size", None) is None:
            raise ValueError("ensemble distillation requires EnsembleCCT(teacher_size=...) "
                             "so the fused token is projected for the token loss")
    mixup_active = mixup is not None and mixup.active
    base_criterion = L.make_base_criterion(mixup_active, smoothing)

    def step(backbone_state: TrainState, ens_state: TrainState, teacher_variables,
             stacked_gates: Optional[Gates], images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator):
        images_m, targets = _mix(mixup_active, mixup, generator, images, labels)
        rows = _rows(layout, images_m.shape[0])
        images_m, targets = batch_rows(rows, images_m, targets)
        D = next(iter(backbone_state.params.values())).shape[0]
        if layout is not None and layout.division_sharded:
            D = layout.num_divisions
        seeds = torch.randint(0, 2 ** 62, (D,), generator=generator,
                              device=generator.device).tolist()
        gens = [torch.Generator(device=generator.device).manual_seed(s) for s in seeds]
        tea_logits = tea_token = None
        if distillation_type != "none":
            with torch.no_grad():
                t_out = _apply(teacher, teacher_variables, images_m)
            tea_logits, tea_token = t_out.logits, t_out.pooled

        feats = _division_tokens(layout, multicct_features, backbone, backbone_state.params,
                                 images_m, _on(stacked_gates, images_m.device), train=True,
                                 generators=gens, rows=rows)
        ens_out = ens_model(feats, distill=True, train=True)
        if distillation_type == "none":
            loss = base_criterion(ens_out.logits, targets)
            metrics = {"loss": loss}
        else:
            token_loss, cls_loss = L.ens_loss(
                ens_out.ens_tokens, ens_out.logits, tea_token, tea_logits, targets,
                base_criterion, model_family="vit", distillation_type=distillation_type,
                alpha=distillation_alpha, tau=distillation_tau, token_loss_type=token_loss_type)
            loss = token_loss + cls_loss
            metrics = {"loss": loss, "token_loss": token_loss, "cls_loss": cls_loss}
        (bb_grads, ens_grads), metrics = _backward(
            layout, loss, [backbone_state, ens_state], metrics)
        backbone_state.apply_gradients(bb_grads)
        ens_state.apply_gradients(ens_grads)
        return backbone_state, ens_state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_cct_ensemble_eval_step(backbone, ens_model, layout: Optional[Layout] = None):
    """step(stacked_params, ens_variables, stacked_gates, images, labels) ->
    summed counters of the CCT ensemble (over the data group under
    `layout`)."""

    @torch.no_grad()
    def step(stacked_params, ens_variables, stacked_gates: Optional[Gates], images, labels):
        dev = _device_of(ens_model)
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        rows = _rows(layout, images.shape[0])
        images, labels = batch_rows(rows, images, labels)
        feats = _division_tokens(layout, multicct_features, backbone, stacked_params, images,
                                 _on(stacked_gates, dev), rows=rows)
        out = _apply(ens_model, ens_variables, feats)
        return _sum_counters(layout, rows, eval_counters(out.logits, labels))

    return step

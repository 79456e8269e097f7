"""Training losses (counterpart of devit_tpu/train/losses.py:22-111): the
part the stage-2 step reaches. All reductions are in f32 whatever the
compute dtype. The DEKD and ensemble losses come with their slices."""

from __future__ import annotations

import torch


def _log_softmax32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(x.float(), dim=dim)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels."""
    logp = _log_softmax32(logits)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    logp = _log_softmax32(logits)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """CE against a soft target distribution (timm SoftTargetCrossEntropy)."""
    logp = _log_softmax32(logits)
    return torch.sum(-target_probs.float() * logp, dim=-1).mean()


def soft_cross_entropy(predict_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """CE between softmax(target) and log_softmax(pred)."""
    logp = _log_softmax32(predict_logits)
    p_t = torch.softmax(target_logits.float(), dim=-1)
    return torch.sum(-p_t * logp, dim=-1).mean()


def make_base_criterion(mixup_active: bool, smoothing: float):
    """mixup -> soft-target CE, else label-smoothing CE (plain CE at 0)."""
    if mixup_active:
        return soft_target_cross_entropy
    if smoothing > 0:
        return lambda logits, labels: label_smoothing_cross_entropy(logits, labels, smoothing)
    return cross_entropy


def soft_distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      tau: float) -> torch.Tensor:
    """KL(student/T || teacher/T) * T^2, summed and divided by B*classes."""
    s = _log_softmax32(student_logits / tau)
    t = _log_softmax32(teacher_logits / tau)
    kl = torch.sum(torch.exp(t) * (t - s))
    return kl * (tau * tau) / student_logits.numel()


def hard_distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    """CE against the teacher's argmax."""
    return cross_entropy(student_logits, teacher_logits.argmax(dim=-1))


def cls_distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                     distillation_type: str, tau: float) -> torch.Tensor:
    if distillation_type == "soft":
        return soft_distill_loss(student_logits, teacher_logits, tau)
    if distillation_type == "hard":
        return hard_distill_loss(student_logits, teacher_logits)
    raise ValueError(f"bad distillation_type {distillation_type!r}")


def distill_loss(cls_logits: torch.Tensor, kd_logits: torch.Tensor,
                 teacher_logits: torch.Tensor, labels: torch.Tensor, base_criterion,
                 distillation_type: str = "hard", alpha: float = 0.5,
                 tau: float = 1.0) -> torch.Tensor:
    """Base loss on the first output, KD loss on the second, blended by alpha."""
    base = base_criterion(cls_logits, labels)
    if distillation_type == "none":
        return base
    kd = cls_distill_loss(kd_logits, teacher_logits, distillation_type, tau)
    return base * (1.0 - alpha) + kd * alpha


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a.float() - b.float()))

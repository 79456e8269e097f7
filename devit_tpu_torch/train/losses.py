"""Training losses (counterpart of devit_tpu/train/losses.py): the
stage-2 criteria, the DEKD relation losses and their alternates, and the
ensemble's EnsLoss. All reductions are in f32 whatever the compute dtype."""

from __future__ import annotations

import math
from typing import Tuple

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


def kldiv_batchmean_log_target(student_log: torch.Tensor, teacher_log: torch.Tensor) -> torch.Tensor:
    """torch.nn.KLDivLoss(reduction='batchmean', log_target=True):
    sum(exp(t) * (t - s)) / batch_size."""
    s, t = student_log.float(), teacher_log.float()
    return torch.sum(torch.exp(t) * (t - s)) / student_log.shape[0]


def feature_relation_loss(teacher_feature: torch.Tensor,
                          student_feature: torch.Tensor) -> torch.Tensor:
    """The DEKD inter-feature loss (losses.py:307-327) over per-layer Q (or K
    or V) of shape (B, H, N, dh): heads concatenated per token, a token Gram
    matrix scaled by 1/sqrt(dh), KL between the log-softmaxed relations,
    batchmean."""

    def relation_log(f: torch.Tensor) -> torch.Tensor:
        B, H, N, d = f.shape
        f = f.permute(0, 2, 1, 3).reshape(B, N, H * d).float()
        rel = torch.matmul(f, f.transpose(-1, -2)) / math.sqrt(d)
        return torch.log_softmax(rel, dim=-1)

    return kldiv_batchmean_log_target(relation_log(student_feature),
                                      relation_log(teacher_feature))


def dekd_qkv_losses(student_qkv: torch.Tensor, teacher_qkv: torch.Tensor,
                    depth: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-Q/K/V relation losses of the captured (3, B, H, N, dh) middle
    layer, each divided by the student's depth (engine.py:102-104)."""
    return tuple(feature_relation_loss(teacher_qkv[i], student_qkv[i]) / depth
                 for i in range(3))


def dekd_loss(student_logits_pair, student_qkv: torch.Tensor, teacher_logits: torch.Tensor,
              teacher_qkv: torch.Tensor, labels: torch.Tensor, base_criterion, *, depth: int,
              gamma: Tuple[float, float, float], distillation_type: str = "hard",
              alpha: float = 0.5, tau: float = 1.0):
    """Full DEKD objective: cls + g0*q + g1*k + g2*v (engine.py:79-106)."""
    cls_logits, kd_logits = student_logits_pair
    cls = distill_loss(cls_logits, kd_logits, teacher_logits, labels, base_criterion,
                       distillation_type, alpha, tau)
    q, k, v = dekd_qkv_losses(student_qkv, teacher_qkv, depth)
    total = cls + gamma[0] * q + gamma[1] * k + gamma[2] * v
    return total, {"cls_loss": cls, "q_loss": q, "k_loss": k, "v_loss": v}


def ens_loss(stu_tokens, stu_logits: torch.Tensor, tea_tokens, tea_logits: torch.Tensor,
             labels: torch.Tensor, base_criterion, *, model_family: str = "deit",
             distillation_type: str = "hard", alpha: float = 0.5, tau: float = 1.0,
             token_loss_type: str = "mse"):
    """EnsLoss (losses.py:180-244): the token-matching loss between the fused
    ensemble token(s) and the teacher's last token(s), and the blended cls
    loss. deit family: (cls, dist) token pairs; vit: single tensors.
    Returns (token_loss, cls_loss)."""
    if token_loss_type == "mse":
        token_criterion = mse_loss
    elif token_loss_type == "kldiv":
        token_criterion = kldiv_batchmean_log_target
    else:
        raise ValueError(token_loss_type)
    cls_loss = ((1.0 - alpha) * base_criterion(stu_logits, labels)
                + alpha * cls_distill_loss(stu_logits, tea_logits, distillation_type, tau))
    if "deit" in model_family:
        (s_cls, s_dist), (t_cls, t_dist) = stu_tokens, tea_tokens
        token_loss = token_criterion(s_cls, t_cls) + token_criterion(s_dist, t_dist)
    else:
        token_loss = token_criterion(stu_tokens, tea_tokens)
    return token_loss, cls_loss


def _gram(a: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    return torch.matmul(a / d ** 0.5, b.transpose(-1, -2))


def qkv_gram_loss(stu_qkv_list, tea_qkv_list) -> torch.Tensor:
    """cal_qkv_loss (losses.py:247-268): all-layer Q/K/V self-Gram matching,
    soft-CE against the teacher's, averaged over 3 projections x layers.
    (B, H, N, dh) is flattened as raw memory to (B, N, H*dh), the
    reference's `.view` quirk, kept for parity."""
    loss = torch.zeros((), dtype=torch.float32)
    for stu_qkv, tea_qkv in zip(stu_qkv_list, tea_qkv_list):
        B, Hs, N, Cs = stu_qkv[0].shape
        _, Ht, _, Ct = tea_qkv[0].shape
        for i in range(3):
            ms = stu_qkv[i].reshape(B, N, Hs * Cs).float()
            mt = tea_qkv[i].reshape(B, N, Ht * Ct).float()
            loss = loss + soft_cross_entropy(_gram(ms, ms, Cs), _gram(mt, mt, Ct))
    return loss / (3.0 * len(stu_qkv_list))


def qkv_cross_gram_loss(stu_qkv_list, tea_qkv_list) -> torch.Tensor:
    """cal_qkv_loss2 (losses.py:271-293): Gram(i, j) = (M_i/sqrt(dh)) M_j^T
    over every pair of Q/K/V, soft-CE against the teacher's, averaged over
    9 pairs x layers; the same flattening quirk as qkv_gram_loss."""
    loss = torch.zeros((), dtype=torch.float32)
    for stu_qkv, tea_qkv in zip(stu_qkv_list, tea_qkv_list):
        B, Hs, N, Cs = stu_qkv[0].shape
        _, Ht, _, Ct = tea_qkv[0].shape
        s_flat = [stu_qkv[i].reshape(B, N, Hs * Cs).float() for i in range(3)]
        t_flat = [tea_qkv[i].reshape(B, N, Ht * Ct).float() for i in range(3)]
        for i in range(3):
            for j in range(3):
                loss = loss + soft_cross_entropy(_gram(s_flat[i], s_flat[j], Cs),
                                                 _gram(t_flat[i], t_flat[j], Ct))
    return loss / (9.0 * len(stu_qkv_list))


def hidden_relation_loss(stu_hid_list, tea_hid_list) -> torch.Tensor:
    """cal_hid_relation_loss (losses.py:296-305): token-relation MSE of the
    L2-normalized hidden states (..., N, C), norm clamped at 1e-12 as torch
    F.normalize does, averaged over layers."""

    def normalize(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)

    loss = torch.zeros((), dtype=torch.float32)
    for stu_hid, tea_hid in zip(stu_hid_list, tea_hid_list):
        s, t = normalize(stu_hid), normalize(tea_hid)
        s_rel = torch.matmul(s, s.transpose(-1, -2))
        t_rel = torch.matmul(t, t.transpose(-1, -2))
        loss = loss + torch.mean(torch.square(s_rel - t_rel))
    return loss / len(stu_hid_list)


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor, topk=(1, 5)):
    """timm-style top-k accuracy in percent."""
    pred = torch.topk(logits, max(topk), dim=-1).indices
    correct = pred == labels.long()[:, None]
    return tuple(100.0 * correct[:, :k].any(dim=-1).float().mean() for k in topk)

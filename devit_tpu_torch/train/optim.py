"""Optimizer, schedules and EMA (counterpart of devit_tpu/train/optim.py),
with optax's semantics written out in torch.

- Schedules map a step count to a learning rate, computed in float32 as the
  JAX package's traced schedules are. optax evaluates a schedule at the
  count BEFORE the update, so step 0 runs at schedule(0) (the warmup LR).
- AdamW: p <- p - lr(t) * (m_hat / (sqrt(v_hat) + eps) + wd * p), decay
  masked by `_decay_mask`; adam/sgd/nesterov/momentum take torch's coupled
  L2 (added to the gradient before the moments).
- Global-norm clipping is optax's: g * max_norm / ||g|| when ||g|| >=
  max_norm (no epsilon, unlike torch's clip_grad_norm_).
- Parameters and optimizer state are {name: tensor} dicts updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]
_f = np.float32


@dataclasses.dataclass
class OptimConfig:
    lr: float = 5e-4
    min_lr: float = 1e-5
    warmup_lr: float = 1e-6
    warmup_epochs: int = 5
    cooldown_epochs: int = 10
    epochs: int = 100
    weight_decay: float = 0.05
    opt_eps: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.999
    clip_grad: Optional[float] = None
    scale_lr_by_batch: bool = False
    global_batch: int = 512
    opt: str = "adamw"  # adamw | adam | sgd | nesterov | momentum
    momentum: float = 0.9
    sched: str = "cosine"  # cosine | step | constant
    decay_epochs: float = 30.0
    decay_rate: float = 0.1
    lr_noise: Optional[tuple] = None  # timm --lr-noise, with sched_per_epoch only
    lr_noise_pct: float = 0.67
    lr_noise_std: float = 1.0  # accepted and inert, as in timm-0.5.4
    seed: int = 42
    sched_per_epoch: bool = False  # timm's per-epoch staircase with its one-epoch lag

    def scaled_lr(self) -> float:
        if self.scale_lr_by_batch:
            return self.lr * self.global_batch / 512.0
        return self.lr


def cosine_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Schedule:
    """timm-0.5.4 CosineLRScheduler, per step: linear warmup warmup_lr -> lr
    over warmup_epochs, then min_lr + 0.5(lr - min_lr)(1 + cos(pi t/T)) with
    t counted from zero including the warmup, floored at min_lr."""
    if cfg.sched_per_epoch:
        return timm_epoch_schedule(cfg, steps_per_epoch)
    peak = cfg.scaled_lr()
    warmup_steps = cfg.warmup_epochs * steps_per_epoch
    total_steps = max(cfg.epochs * steps_per_epoch, warmup_steps + 1)

    def schedule(step: int) -> float:
        t = _f(step)
        warm = _f(cfg.warmup_lr) + _f(peak - cfg.warmup_lr) * t / _f(max(warmup_steps, 1))
        progress = np.minimum(t / _f(total_steps), _f(1.0))
        cos = _f(cfg.min_lr) + _f(0.5 * (peak - cfg.min_lr)) * (_f(1.0) + np.cos(_f(np.pi) * progress))
        return float(warm if t < warmup_steps else cos)

    return schedule


def step_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Schedule:
    """timm-0.5.4 StepLRScheduler: warmup as for cosine (per step), then
    peak * decay_rate ** (epoch // decay_epochs), no min_lr floor."""
    peak = cfg.scaled_lr()
    warmup_steps = cfg.warmup_epochs * steps_per_epoch
    decay_t = max(float(cfg.decay_epochs), 1.0)

    def schedule(step: int) -> float:
        t = _f(step)
        warm = _f(cfg.warmup_lr) + _f(peak - cfg.warmup_lr) * t / _f(max(warmup_steps, 1))
        epoch = np.floor(t / _f(steps_per_epoch))
        dec = _f(peak) * _f(cfg.decay_rate) ** np.floor(epoch / _f(decay_t))
        return float(warm if t < warmup_steps else dec)

    return schedule


def warmup_constant_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """Linear 0 -> base_lr over warmup_steps, then constant."""

    def schedule(step: int) -> float:
        t = _f(step)
        return float(_f(base_lr) * (t / _f(max(1.0, warmup_steps)) if t < warmup_steps else _f(1.0)))

    return schedule


def warmup_linear_schedule(base_lr: float, warmup_steps: int, t_total: int) -> Schedule:
    """Linear warmup, then linear decay to 0 at t_total (clamped at 0)."""

    def schedule(step: int) -> float:
        t = _f(step)
        warm = t / _f(max(1.0, warmup_steps))
        decay = np.maximum(_f(0.0), (_f(t_total) - t) / _f(max(1.0, t_total - warmup_steps)))
        return float(_f(base_lr) * (warm if t < warmup_steps else decay))

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, t_total: int,
                           cycles: float = 0.5) -> Schedule:
    """Linear warmup, then cosine decay over the remaining steps; `cycles`
    scales the frequency, clamped at 0."""

    def schedule(step: int) -> float:
        t = _f(step)
        warm = t / _f(max(1.0, warmup_steps))
        progress = (t - _f(warmup_steps)) / _f(max(1.0, t_total - warmup_steps))
        cos = np.maximum(_f(0.0), _f(0.5) * (_f(1.0) + np.cos(_f(np.pi) * _f(cycles * 2.0) * progress)))
        return float(_f(base_lr) * (warm if t < warmup_steps else cos))

    return schedule


def build_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Schedule:
    """Dispatch on cfg.sched as timm's create_scheduler does; unsupported
    names raise (plateau needs eval-metric feedback)."""
    if cfg.lr_noise is not None and not (cfg.sched_per_epoch and cfg.sched in ("cosine", "step")):
        raise ValueError("--lr-noise is timm's per-epoch noise: use it with "
                         "--sched-per-epoch and sched cosine|step")
    if cfg.sched == "cosine":
        return cosine_schedule(cfg, steps_per_epoch)
    if cfg.sched == "step":
        if cfg.sched_per_epoch:
            return timm_epoch_schedule(cfg, steps_per_epoch)
        return step_schedule(cfg, steps_per_epoch)
    if cfg.sched == "constant":
        peak = cfg.scaled_lr()
        return lambda step: peak
    raise ValueError(f"--sched {cfg.sched!r} is not implemented (supported: cosine, "
                     "step, constant)")


def timm_epoch_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Schedule:
    """The reference's per-epoch staircase: timm-0.5.4 stepped at the END of
    each epoch, so epoch e trains at _get_lr(max(e - 1, 0)) (one-epoch lag),
    times timm's LR noise from epoch 1 on when lr_noise is set."""
    peak = cfg.scaled_lr()
    wt = cfg.warmup_epochs
    t_initial = max(cfg.epochs, 1)

    def get_lr(t: int) -> np.float32:
        t = _f(t)
        warm = _f(cfg.warmup_lr) + t * _f(peak - cfg.warmup_lr) / _f(max(wt, 1))
        if cfg.sched == "step":
            decayed = _f(peak) * _f(cfg.decay_rate) ** np.floor(t / _f(max(float(cfg.decay_epochs), 1.0)))
        else:
            decayed = _f(cfg.min_lr) + _f(0.5 * (peak - cfg.min_lr)) * (
                _f(1.0) + np.cos(_f(np.pi) * t / _f(t_initial)))
            decayed = _f(cfg.min_lr) if t >= t_initial else decayed
        return warm if t < wt else decayed

    factors = None
    if cfg.lr_noise is not None:
        factors = _timm_noise_factors(cfg, n_epochs=max(cfg.epochs + cfg.cooldown_epochs, 1) + 2)

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        t = max(epoch - 1, 0)
        lr = get_lr(t)
        if factors is not None and epoch >= 1:
            lr = lr * _f(factors[min(t, len(factors) - 1)])
        return float(lr)

    return schedule


def _timm_noise_factors(cfg: OptimConfig, n_epochs: int) -> np.ndarray:
    """Per-epoch (1 + noise(t)) table matching timm-0.5.4 _add_noise with
    noise_type='normal' and noise_seed = seed (noise_std is inert there)."""
    rng = [n * cfg.epochs for n in cfg.lr_noise]
    lo, hi = (rng[0], rng[1]) if len(rng) > 1 else (rng[0], float("inf"))
    out = np.ones(n_epochs, dtype=np.float64)
    for t in range(n_epochs):
        if not (lo <= t < hi):
            continue
        g = torch.Generator()
        g.manual_seed(cfg.seed + t)
        while True:
            noise = torch.randn(1, generator=g).item()
            if abs(noise) < cfg.lr_noise_pct:
                break
        out[t] = 1.0 + noise
    return out


_NO_DECAY_NAMES = {"pos_embed", "cls_token", "dist_token", "bias", "scale"}


def _decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies, judged on the scan-stacked flax tree:
    no name on the path in _NO_DECAY_NAMES and at least 2-D there (a
    `blocks.<i>.*` parameter carries the stacked depth axis as well)."""
    out = {}
    for name, p in params.items():
        parts = name.split(".")
        ndim = p.ndim + (1 if parts[0] == "blocks" else 0)
        out[name] = not any(n in _NO_DECAY_NAMES for n in parts) and ndim >= 2
    return out


@dataclasses.dataclass
class Optimizer:
    """The chain make_optimizer builds, applied in place to {name: tensor}."""

    opt: str
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: Optional[float] = None
    clip_grad: Optional[float] = None
    # where the parameters are one rank's share of a division-sharded state,
    # the sum of the clip's squares over the ranks that hold the rest
    # (set by parallel/mesh.shard_state: Layout.sum_over_div)
    sumsq_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = dataclasses.field(
        default=None, compare=False, repr=False)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        state = {"count": 0, "mask": _decay_mask(params)}
        if self.opt in ("adamw", "adam"):
            state.update(mu=zeros(), nu=zeros())
        elif self.momentum:
            state.update(trace=zeros())
        return state

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]) -> None:
        names = list(params)
        g = [grads[k].float() for k in names]
        p = [params[k] for k in names]
        if self.clip_grad is not None:
            sumsq = sum(torch.sum(x * x) for x in g)
            if self.sumsq_reduce is not None:
                sumsq = self.sumsq_reduce(sumsq)
            norm = torch.sqrt(sumsq)
            g = [torch.where(norm < self.clip_grad, x, x / norm * self.clip_grad) for x in g]
        decay = [state["mask"][k] for k in names]
        lr = self.schedule(state["count"])
        wd = self.weight_decay
        if self.opt != "adamw" and wd:  # coupled L2 before the moments
            g = [x + wd * w if d else x for x, w, d in zip(g, p, decay)]
        if self.opt in ("adamw", "adam"):
            count = state["count"] + 1
            bc1 = float(_f(1.0) - _f(self.b1) ** _f(count))
            bc2 = float(_f(1.0) - _f(self.b2) ** _f(count))
            for k, x, w, d in zip(names, g, p, decay):
                mu, nu = state["mu"][k], state["nu"][k]
                mu.mul_(self.b1).add_(x, alpha=1.0 - self.b1)
                nu.mul_(self.b2).add_(x * x, alpha=1.0 - self.b2)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if self.opt == "adamw" and d and wd:
                    u = u + wd * w
                w.add_(u, alpha=-lr)
        else:
            nesterov = self.opt in ("sgd", "nesterov")
            for k, x, w in zip(names, g, p):
                u = x
                if self.momentum:
                    tr = state["trace"][k]
                    tr.mul_(self.momentum).add_(x)
                    u = x + self.momentum * tr if nesterov else tr
                w.add_(u, alpha=-lr)
        state["count"] += 1


def make_optimizer(cfg: OptimConfig, steps_per_epoch: int,
                   schedule: Optional[Schedule] = None) -> Optimizer:
    sched = schedule if schedule is not None else build_schedule(cfg, steps_per_epoch)
    opt = cfg.opt.lower()
    if opt not in ("adamw", "adam", "sgd", "nesterov", "momentum"):
        raise ValueError(f"--opt {cfg.opt!r} is not implemented (supported: adamw, adam, "
                         "sgd, nesterov, momentum)")
    return Optimizer(opt=opt, schedule=sched, b1=cfg.beta1, b2=cfg.beta2, eps=cfg.opt_eps,
                     weight_decay=cfg.weight_decay,
                     momentum=(cfg.momentum or None) if opt not in ("adamw", "adam") else None,
                     clip_grad=cfg.clip_grad)


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.99996) -> None:
    """timm ModelEma: e <- e * decay + p * (1 - decay), in place."""
    for k, e in ema_params.items():
        e.mul_(decay).add_(params[k].to(e.dtype), alpha=1.0 - decay)

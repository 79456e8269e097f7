"""Training steps of a sparse-expert ViT (V-MoE): the port's stage-2 step
(`make_stage2_step`, its loss with the auxiliary losses) over batches of
`batch` images at `img_size` pixels, driven by `train_epoch` with a seeded
CPU generator for the mixup, drop-path and router-noise draws, as
`train_steps` drives the dense ViT.

Set-up builds the model on the card and one training state, and drives it
through `checked_steps` steps on distinct batches through the window's own
call and feed, keeping what the check needs on the host: the losses, each
leaf's first-gradient norm, the parameters after the checked steps, and
every MoE layer's input and expert choices of each checked step. The
window then runs whole steps until its time is up and ends in a
synchronize; the MoE layers' route counters are read once after it. A
traced slice also hands the readers the device time of the kernels
launched inside each of the program's MoE spans, from the profiler's
events.

The check (once the program is freed) runs the reference
(`reference/vmoe.py`) over the checked steps from the same leaves,
batches and draws, routed by the program's choices (teacher-forced), and
compares leaf by leaf: `loss_gap`, `grad_gap` and `change_gap` as
`train_steps.numbers` defines them, and `route_disagree`, the share of the
program's token choice pairs that the reference's own top-K, on the
program's layer input with the same noise, does not repeat."""

from __future__ import annotations

import gc
import math
import time
from typing import Optional

import torch

from benchmark import core, weights
from benchmark.drivers.train_steps import model_config
from benchmark.metrics import _moe_counts
from benchmark.reference import vmoe as ref
from benchmark.reference.model import Precision, set_strict_f32
from benchmark.tracing import Profiler

MOE_KEYS = ("num_experts", "top_k", "capacity_ratio", "aux_loss_weight")


def build(cfg: dict, device, seed: int):
    """(model, state, step) of the port, built on `device`, its parameters
    the seeded leaves."""
    from devit_tpu_torch.configs import get_vit_config
    from devit_tpu_torch.data.mixup import MixupConfig
    from devit_tpu_torch.models.vit import VisionTransformer
    from devit_tpu_torch.train.optim import OptimConfig, make_optimizer
    from devit_tpu_torch.train.state import TrainState
    from devit_tpu_torch.train.steps import make_stage2_step

    vcfg = get_vit_config(cfg["model"], img_size=cfg["img_size"], patch_size=cfg["patch_size"],
                          embed_dim=cfg["embed_dim"], depth=cfg["depth"],
                          num_heads=cfg["num_heads"], mlp_ratio=cfg["mlp_ratio"],
                          num_classes=cfg["num_classes"], distilled=cfg["distilled"],
                          layer_norm_eps=cfg["layer_norm_eps"],
                          drop_path_rate=cfg["drop_path_rate"],
                          moe_layers=tuple(cfg["moe_layers"]),
                          **{k: cfg[k] for k in MOE_KEYS})
    with torch.device(device):
        model = VisionTransformer(vcfg, dtype=getattr(torch, cfg["dtype"]),
                                  use_kernel=cfg["use_kernel"], use_remat=cfg["use_remat"])
    leaves = weights.seeded_leaves(ref.leaf_shapes(cfg), seed, device)
    with torch.no_grad():
        named = dict(model.named_parameters())
        if set(named) != set(leaves):
            raise ValueError(f"the port's parameters {sorted(set(named) ^ set(leaves))} "
                             "differ from the benchmark's leaves")
        for k, p in named.items():
            p.copy_(leaves[k])
    del leaves
    o = cfg["optimizer"]
    tx = make_optimizer(OptimConfig(lr=o["lr"], min_lr=o["min_lr"], warmup_lr=o["warmup_lr"],
                                    warmup_epochs=o["warmup_epochs"], epochs=o["epochs"],
                                    weight_decay=o["weight_decay"], opt_eps=o["eps"],
                                    beta1=o["beta1"], beta2=o["beta2"], clip_grad=o["clip_grad"],
                                    opt=o["opt"], sched="cosine"), o["steps_per_epoch"])
    ema = cfg["ema_decay"]
    state = TrainState.create(model, tx, use_ema=ema is not None,
                              **({} if ema is None else {"ema_decay": ema}))
    m = cfg["mixup"]
    mix = MixupConfig(mixup_alpha=m["mixup_alpha"], cutmix_alpha=m["cutmix_alpha"],
                      prob=m["prob"], switch_prob=m["switch_prob"],
                      label_smoothing=m["label_smoothing"], num_classes=cfg["num_classes"])
    step = make_stage2_step(model, None, mixup=mix, smoothing=cfg["smoothing"],
                            distillation_type=cfg["distillation"])
    return model, state, step


def drive(cell: core.Cell):
    """Set-up, checked steps and window: (Outcome without its numbers, what
    the check reads: {losses, grad_norms, after, routing})."""
    from devit_tpu_torch.models import moe
    from devit_tpu_torch.train.loop import train_epoch

    tr, cfg, dev = cell.traffic, model_config(cell), torch.device(cell.device)
    B, checked = tr["batch"], tr["checked_steps"]
    t_build = time.perf_counter()
    model, state, step = build(cfg, dev, cell.seed)
    batches = weights.train_batches(tr["pool_batches"], B, cfg["img_size"], cfg["num_classes"],
                                    cell.seed, dev)
    spans = core.Spans()
    losses, grad_norms, routing, t_first = [], {}, [], []
    b1 = cfg["optimizer"]["beta1"]

    def step_fn(state, images, labels, generator):
        if len(losses) >= checked:
            return spans.span("step", step, state, None, images, labels, generator)
        with moe.capture_routing(model) as rec:
            state, metrics = spans.span("step", step, state, None, images, labels, generator)
        routing.append({i: (h.cpu(), c.cpu()) for i, (h, c) in sorted(rec.items())})
        losses.append(metrics["loss"])
        if len(losses) == 1:  # the first gradient as the optimizer took it
            mu = state.opt_state["mu"]
            norms = torch.stack([m.float().norm() for m in mu.values()]).cpu() / (1.0 - b1)
            grad_norms.update(zip(mu, norms.tolist()))
            t_first.append(time.perf_counter())
        return state, metrics

    def quiet(*_):
        return None

    gen = weights.generator(cell.seed, "draws")
    t_steps = time.perf_counter()
    state, _, gen = train_epoch(step_fn, state, batches[:checked], gen, epoch=0,
                                log_fn=quiet, print_freq=10 ** 9)
    after = {k: p.detach().float().to("cpu", copy=True) for k, p in state.params.items()}
    losses = [float(l) for l in losses]
    cell.log(f"set-up: model, state and batches {t_steps - t_build:.3f} s, the first step "
             f"{t_first[0] - t_steps:.3f} s, the other checked steps and the copies "
             f"{time.perf_counter() - t_first[0]:.3f} s")

    moe.reset_route_counts(model)
    core.settle()
    steps = traced = 0
    prof = trace = None
    untraced, slice_s = core.trace_plan(cell.seconds, cell.trace, tr["trace_s"])

    def feed():
        nonlocal steps, traced, prof
        i = checked
        while True:
            now = time.perf_counter()
            if now >= (t0 + cell.seconds if prof is None else prof.started + slice_s):
                return
            if cell.trace and prof is None and now >= t0 + untraced:
                prof = Profiler()
                prof.start()
            if prof is not None:
                traced += 1
            steps += 1
            yield batches[i % len(batches)]
            i += 1

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _, gen = train_epoch(step_fn, state, feed(), gen, epoch=1, log_fn=quiet,
                                print_freq=10 ** 9)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    span_kernel_s = None
    if prof is not None:
        trace = prof.stop(spans.items)
        span_kernel_s = _moe_counts.launched_in(prof._prof.events(), _moe_counts.SPANS)
        prof = None
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    ctx = {"config": cfg, "traffic": tr, "window_s": t1 - t0, "steps": steps, "batch": B,
           "traced_steps": traced, "trace": trace, "route_counts": moe.route_counts(model),
           "moe_span_kernel_s": span_kernel_s}
    del model, state, step, batches, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = core.Outcome(e2e={"train_img_per_s": steps * B / (t1 - t0)}, window_start=t0,
                       attempted=steps, failed=0, memory_peak_bytes=peak, numbers={}, ctx=ctx)
    return out, {"losses": losses, "grad_norms": grad_norms, "after": after, "routing": routing}


def run(cell: core.Cell) -> core.Outcome:
    out, got = drive(cell)
    out.numbers = check(cell, got)
    return out


def reference_steps(cell: core.Cell, prec: str = "f32", fault: Optional[str] = None,
                    routing: Optional[list] = None, record: bool = False,
                    host: bool = False) -> dict:
    """The reference (or, with prec="fp8", the control) over the checked
    steps from the same leaves, batches and draws, routed by `routing` (a
    run's [{layer: (h, choice)}] a step) where given, else by its own top-K:
    {losses, grad_norms, keep, after (on the card, or the host with
    host=True), route_disagree (None without routing), routing (its own,
    with record=True)}. keep[leaf]: None (every entry), False (none) or the
    mask of the entries whose first gradient is at least a thousandth of
    the median leaf's RMS gradient."""
    tr, cfg, dev = cell.traffic, model_config(cell), torch.device(cell.device)
    set_strict_f32()
    leaves = weights.seeded_leaves(ref.leaf_shapes(cfg), cell.seed, dev)
    batches = weights.train_batches(tr["pool_batches"], tr["batch"], cfg["img_size"],
                                    cfg["num_classes"], cell.seed, dev)
    gen = weights.generator(cell.seed, "draws")
    r = ref.VMoEReference(leaves, cfg, Precision(prec))
    del leaves
    losses, norms, keep, own, disagree = [], {}, {}, [], [0, 0]
    for s, (images, labels) in enumerate(batches[:tr["checked_steps"]]):
        forced = inputs = None
        if routing is not None:
            forced = {i: c for i, (_, c) in routing[s].items()}
            inputs = {i: h for i, (h, _) in routing[s].items()}
        rec = {} if record else None
        loss, grads, dis = r.step(images, labels, gen, fault=fault, forced=forced,
                                  inputs=inputs, record=rec)
        losses.append(float(loss))
        if rec is not None:
            own.append(dict(sorted(rec.items())))
        if dis is not None:
            disagree = [disagree[0] + dis[0], disagree[1] + dis[1]]
        if s == 0:
            n = torch.stack([g.norm() for g in grads.values()]).cpu().tolist()
            norms = dict(zip(grads, n))
            rms = sorted(v / g.numel() ** 0.5 for v, g in zip(n, grads.values()))
            floor = 1e-3 * rms[len(rms) // 2]
            for k, g in grads.items():
                mask = g.abs() >= floor
                everywhere, nowhere = bool(mask.all()), not bool(mask.any())
                keep[k] = None if everywhere else (False if nowhere else mask)
        del grads
    r.mu = r.nu = None
    after = {k: (p.detach().cpu() if host else p.detach()) for k, p in r.params.items()}
    if host:
        keep = {k: (m.cpu() if isinstance(m, torch.Tensor) else m) for k, m in keep.items()}
    del r
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "keep": keep, "after": after,
            "route_disagree": disagree[0] / disagree[1] if disagree[1] else None,
            "routing": own if record else None}


def before_leaves(cell: core.Cell) -> dict:
    """The seeded leaves again, on the card."""
    return weights.seeded_leaves(ref.leaf_shapes(model_config(cell)), cell.seed,
                                 torch.device(cell.device))


def numbers(got: dict, want: dict, before: dict) -> dict:
    """loss_gap, grad_gap and change_gap as train_steps.numbers defines them
    (the change over the entries `want["keep"]` keeps), leaf by leaf on
    before's device; route_disagree: the reference's reading of the
    program's routing, where it read one."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    gw, gg = want["grad_norms"], got["grad_norms"]
    med_g = sorted(gw.values())[len(gw) // 2]
    grad_gap = max(abs(gg[k] - gw[k]) / max(gw[k], med_g) for k in gw)
    cw, cg = {}, {}
    for k, b in before.items():
        mask = want["keep"][k]
        if mask is False:
            continue
        dw = want["after"][k].to(b.device) - b
        dg = got["after"][k].to(b.device) - b
        if mask is not None:
            mask = mask.to(b.device)
            dw, dg = dw[mask], dg[mask]
        cw[k], cg[k] = float(dw.norm()), float(dg.norm())
    med_c = sorted(cw.values())[len(cw) // 2]
    change_gap = max(abs(cg[k] - cw[k]) / max(cw[k], med_c) for k in cw)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    if want.get("route_disagree") is not None:
        out["route_disagree"] = want["route_disagree"]
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def check(cell: core.Cell, got: dict) -> dict:
    if len(got["losses"]) != cell.traffic["checked_steps"] or not got["grad_norms"]:
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf,
                "route_disagree": math.inf}
    want = reference_steps(cell, routing=got["routing"])
    return numbers(got, want, before_leaves(cell))

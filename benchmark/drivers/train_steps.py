"""Training steps: the port's stage-2 step (`make_stage2_step`) over batches
of `batch` images at `img_size` pixels, driven by its epoch loop
(`train_epoch`) with a seeded CPU generator for the mixup and drop-path
draws.

Set-up builds one training state and drives it through `checked_steps`
steps on batches that all differ, through the same call and feed as the
window; the reference follows those steps. The window then runs whole steps
until its time is up and ends in a synchronize. The end-to-end metric is
the images of every completed step over the window's length."""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import core, weights
from benchmark.reference import model as ref
from benchmark.reference.stage2 import Stage2Reference
from benchmark.tracing import Profiler


def model_config(cell: core.Cell) -> dict:
    """The configuration at the cell's image size."""
    return {**cell.config, "img_size": cell.traffic["img_size"]}


def build(cfg: dict, device, seed: int):
    """(model, state, step) of the port, its parameters the seeded leaves."""
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
                          drop_path_rate=cfg["drop_path_rate"])
    model = VisionTransformer(vcfg, dtype=getattr(torch, cfg["dtype"]),
                              use_kernel=cfg["use_kernel"], use_remat=cfg["use_remat"]).to(device)
    leaves = weights.seeded_leaves(ref.leaf_shapes(cfg), seed, device)
    with torch.no_grad():
        named = dict(model.named_parameters())
        if set(named) != set(leaves):
            raise ValueError(f"the port's parameters {sorted(set(named) ^ set(leaves))} "
                             "differ from the benchmark's leaves")
        for k, p in named.items():
            p.copy_(leaves[k])
    o = cfg["optimizer"]
    tx = make_optimizer(OptimConfig(lr=o["lr"], min_lr=o["min_lr"], warmup_lr=o["warmup_lr"],
                                    warmup_epochs=o["warmup_epochs"], epochs=o["epochs"],
                                    weight_decay=o["weight_decay"], opt_eps=o["eps"],
                                    beta1=o["beta1"], beta2=o["beta2"], clip_grad=o["clip_grad"],
                                    opt=o["opt"], sched="cosine"), o["steps_per_epoch"])
    state = TrainState.create(model, tx, use_ema=True, ema_decay=cfg["ema_decay"])
    m = cfg["mixup"]
    mix = MixupConfig(mixup_alpha=m["mixup_alpha"], cutmix_alpha=m["cutmix_alpha"],
                      prob=m["prob"], switch_prob=m["switch_prob"],
                      label_smoothing=m["label_smoothing"], num_classes=cfg["num_classes"])
    step = make_stage2_step(model, None, mixup=mix, smoothing=cfg["smoothing"],
                            distillation_type=cfg["distillation"])
    return model, state, step


def run(cell: core.Cell) -> core.Outcome:
    from devit_tpu_torch.train.loop import train_epoch

    tr, cfg, dev = cell.traffic, model_config(cell), torch.device(cell.device)
    B, checked = tr["batch"], tr["checked_steps"]
    t_build = time.perf_counter()
    model, state, step = build(cfg, dev, cell.seed)
    batches = weights.train_batches(tr["pool_batches"], B, cfg["img_size"], cfg["num_classes"],
                                    cell.seed, dev)
    spans = core.Spans()
    losses, first_grads, t_first = [], {}, []
    b1 = cfg["optimizer"]["beta1"]

    def step_fn(state, images, labels, generator):
        state, metrics = spans.span("step", step, state, None, images, labels, generator)
        if len(losses) < checked:
            losses.append(metrics["loss"])
            if len(losses) == 1:  # the first gradient as the optimizer took it
                first_grads.update({k: (m / (1.0 - b1)).cpu().clone()
                                    for k, m in state.opt_state["mu"].items()})
                t_first.append(time.perf_counter())
        return state, metrics

    def quiet(*_):
        return None

    gen = weights.generator(cell.seed, "draws")
    t_steps = time.perf_counter()
    state, _, gen = train_epoch(step_fn, state, batches[:checked], gen, epoch=0,
                                log_fn=quiet, print_freq=10 ** 9)
    after = {k: p.detach().float().cpu().clone() for k, p in state.params.items()}
    losses = [float(l) for l in losses]
    cell.log(f"set-up: model, state and batches {t_steps - t_build:.3f} s, the first step "
             f"{t_first[0] - t_steps:.3f} s, the other checked steps "
             f"{time.perf_counter() - t_first[0]:.3f} s")

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
    if prof is not None:
        trace = prof.stop(spans.items)
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    ctx = {"config": cfg, "traffic": tr, "window_s": t1 - t0, "steps": steps, "batch": B,
           "traced_steps": traced, "trace": trace}
    del model, state, step, batches, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cell, {"losses": losses, "first_grads": first_grads, "after": after})
    return core.Outcome(e2e={"train_img_per_s": steps * B / (t1 - t0)}, window_start=t0,
                        attempted=steps, failed=0, memory_peak_bytes=peak, numbers=numbers,
                        ctx=ctx)


def reference_steps(cell: core.Cell, prec: str = "f32", fault=None) -> dict:
    """The reference (or, with prec="fp8", the control) over the checked
    steps from the same leaves, batches and draws: {losses, first_grads,
    after}, and the reference's first gradients as `ref_grads`."""
    tr, cfg, dev = cell.traffic, model_config(cell), torch.device(cell.device)
    ref.set_strict_f32()
    leaves = weights.seeded_leaves(ref.leaf_shapes(cfg), cell.seed, dev)
    batches = weights.train_batches(tr["pool_batches"], tr["batch"], cfg["img_size"],
                                    cfg["num_classes"], cell.seed, dev)
    gen = weights.generator(cell.seed, "draws")
    r = Stage2Reference(leaves, cfg, ref.Precision(prec))
    losses, first = [], None
    for images, labels in batches[:tr["checked_steps"]]:
        loss, grads = r.step(images, labels, gen, fault=fault)
        losses.append(float(loss))
        if first is None:
            first = {k: g.detach().float().cpu() for k, g in grads.items()}
    return {"losses": losses, "first_grads": first,
            "after": {k: p.detach().float().cpu() for k, p in r.params.items()},
            "before": {k: v.detach().float().cpu() for k, v in leaves.items()}}


def numbers(got: dict, want: dict) -> dict:
    """loss_gap: the widest relative gap of a checked step's loss.
    grad_gap: over the leaves, the gap between the norms of the first
    gradient, over the reference's norm of that leaf or of the median leaf,
    whichever is larger. change_gap: the same of the parameters' change over
    the checked steps. The change leaves out every entry whose reference
    gradient is under a thousandth of the median leaf's RMS gradient: such
    an entry (a key's bias under softmax, which the port keeps inside the
    fused qkv bias) moves under Adam by round-off alone."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    gw = {k: float(v.norm()) for k, v in want["first_grads"].items()}
    gg = {k: float(got["first_grads"][k].norm()) for k in gw}
    med_g = sorted(gw.values())[len(gw) // 2]
    grad_gap = max(abs(gg[k] - gw[k]) / max(gw[k], med_g) for k in gw)
    rms = sorted(float(v.norm()) / v.numel() ** 0.5 for v in want["first_grads"].values())
    floor = 1e-3 * rms[len(rms) // 2]
    cw, cg = {}, {}
    for k, g in want["first_grads"].items():
        keep = g.abs() >= floor
        if keep.any():
            cw[k] = float((want["after"][k] - want["before"][k])[keep].norm())
            cg[k] = float((got["after"][k] - want["before"][k])[keep].norm())
    med_c = sorted(cw.values())[len(cw) // 2]
    change_gap = max(abs(cg[k] - cw[k]) / max(cw[k], med_c) for k in cw)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def check(cell: core.Cell, got: dict) -> dict:
    if len(got["losses"]) != cell.traffic["checked_steps"] or not got["first_grads"]:
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf}
    return numbers(got, reference_steps(cell))

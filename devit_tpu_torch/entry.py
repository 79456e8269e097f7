"""Entry points for automated runs (counterpart of the JAX package's __graft_entry__.py).

- entry(): the flagship forward, the 4-division dedeit collaborative
  ensemble (reference engine.py:212-242) at 224 px, batch 8, 100 classes, on
  the card with the attention kernel; returns (fn, example_args).
- dryrun_multichip(n): the stage-5 ensemble training step over n ranks
  (the division axis over ranks, the batch over the rest), then the
  stage-2 and DEKD data-parallel steps, each held to the one-process step,
  and the collaborative-serving topology with its lag-2 stream held to the
  one-device fused forward; at the JAX dry run's tiny shapes, on the card
  (ranks that share one card join over gloo) unless the caller asks for the
  CPU. Run as a script it calls dryrun_multichip(8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from devit_tpu_torch.device import DeviceLike, resolve_device

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=5)


def entry(device: DeviceLike = None):
    """Returns (fn, example_args): fn(stacked_params, ens_params, images) ->
    logits (8, 100), the ensemble forward on `device` (the card unless the
    caller asks for the CPU), weights drawn from fixed seeds."""
    from devit_tpu_torch.models.ensemble import EnsMLP, ensemble_forward, init_multivit
    from devit_tpu_torch.models.vit import create_vit

    dev = resolve_device(device)
    num_div, num_classes, batch = 4, 100, 8
    model = create_vit("dedeit", num_classes=25, device=dev)
    ens = EnsMLP(num_classes=num_classes, sub_size=model.cfg.embed_dim, num_divisions=num_div,
                 teacher_size=768, family="deit")
    ens = ens.reset_parameters(torch.Generator().manual_seed(1)).to(dev)
    stacked = {k: v.detach() for k, v in init_multivit(
        model, [torch.Generator().manual_seed(d) for d in range(num_div)]).items()}
    ens_params = {k: v.detach() for k, v in ens.named_parameters()}

    @torch.no_grad()
    def fn(stacked_params, ens_params, images):
        return ensemble_forward(model, ens, stacked_params, ens_params, images).logits

    images = torch.randn((batch, 224, 224, 3), generator=torch.Generator().manual_seed(2))
    return fn, (stacked, ens_params, images.to(dev))


def _num_divisions(n: int) -> int:
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def _dryrun_steps(n: int, parallel: bool = True, device: DeviceLike = None) -> dict:
    """The dry run's three training steps on one rank of n (parallel) or in
    one process over the same global batches, on `device`; returns their
    losses and the layout's shape."""
    from devit_tpu_torch.configs import get_vit_config
    from devit_tpu_torch.models.ensemble import EnsMLP, init_multivit, stack_division_gates
    from devit_tpu_torch.models.vit import VisionTransformer, full_gates
    from devit_tpu_torch.parallel import mesh as M
    from devit_tpu_torch.train import steps as S
    from devit_tpu_torch.train.optim import OptimConfig, make_optimizer
    from devit_tpu_torch.train.state import TrainState

    dev = resolve_device(device)
    D = _num_divisions(n)
    batch = 2 * (n // D)
    tx = lambda: make_optimizer(OptimConfig(lr=1e-3, epochs=1, warmup_epochs=0,
                                            cooldown_epochs=0, clip_grad=1.0), 1)
    vit = lambda cfg, seed=None: (
        VisionTransformer(cfg, dtype=torch.float32) if seed is None else
        VisionTransformer(cfg, dtype=torch.float32).reset_parameters(
            torch.Generator().manual_seed(seed))).to(dev)
    backbone = vit(get_vit_config("dedeit", **TINY))
    teacher = vit(get_vit_config("deit_base_distilled_patch16_224",
                                 **{**TINY, "embed_dim": 128, "num_heads": 8,
                                    "num_classes": 5 * D}), seed=1)
    ens = EnsMLP(num_classes=5 * D, sub_size=64, num_divisions=D, teacher_size=128,
                 family="deit", dtype=torch.float32).reset_parameters(
        torch.Generator().manual_seed(2)).to(dev)
    stacked = init_multivit(backbone, [torch.Generator().manual_seed(10 + d) for d in range(D)])
    bb_state, ens_state = TrainState.create(stacked, tx()), TrainState.create(ens, tx())
    gates = stack_division_gates([full_gates(backbone.cfg, device=dev)] * D)
    layout = M.ensemble_layout(D) if parallel else None
    if layout is not None:
        M.shard_state(bb_state, layout)
        gates = type(gates)(**M.shard_division_tree(gates._asdict(), layout))
    step = S.make_ensemble_train_step(backbone, ens, teacher, distillation_type="hard",
                                      layout=layout)
    images = torch.randn((batch, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    labels = torch.zeros((batch,), dtype=torch.int64)
    _, _, m5 = step(bb_state, ens_state, None, gates, images.to(dev), labels.to(dev),
                    torch.Generator().manual_seed(4))

    # stage 2 and DEKD, data-parallel over every rank
    dp = M.data_layout() if parallel else None
    x2 = torch.randn((2 * n, 32, 32, 3), generator=torch.Generator().manual_seed(6)).to(dev)
    y2 = torch.zeros((2 * n,), dtype=torch.int64, device=dev)
    student = vit(get_vit_config("dedeit", **TINY), seed=5)
    s2 = S.make_stage2_step(student, smoothing=0.0, layout=dp)
    _, m2 = s2(TrainState.create(student, tx()), None, x2, y2, torch.Generator().manual_seed(7))
    student.reset_parameters(torch.Generator().manual_seed(8))
    dekd_teacher = vit(get_vit_config("deit_base_distilled_patch16_224",
                                      **{**TINY, "embed_dim": 128, "num_heads": 8}), seed=9)
    s4 = S.make_dekd_step(student, dekd_teacher, distillation_type="hard", layout=dp)
    _, m4 = s4(TrainState.create(student, tx()), None, full_gates(student.cfg, device=dev),
               x2, y2, torch.Generator().manual_seed(10))
    return {"shape": None if layout is None else layout.shape, "loss": float(m5["loss"]),
            "stage2": float(m2["loss"]), "dekd": float(m4["loss"]), "q_loss": float(m4["q_loss"])}


def _serving_topology(D: int, n: int, device: torch.device) -> dict:
    """The deployed ragged divisions of the dry run's backbone served by
    the collaborative server on serving_devices(device), against the same
    divisions fused on one device; then its lag-2 stream against per-batch
    serving; and the placement the server gives on n devices. Returns
    max |served - fused|, max |streamed - served|, the server, and the
    n-device placement."""
    from torch.func import functional_call

    from devit_tpu_torch.configs import get_vit_config
    from devit_tpu_torch.core.rank import build_gates
    from devit_tpu_torch.io.bridge import stacked_vit_to_jax_params
    from devit_tpu_torch.models.compact_vit import compact_vit_ragged, stack_division_features
    from devit_tpu_torch.models.ensemble import EnsMLP, init_multivit
    from devit_tpu_torch.models.vit import VisionTransformer, map_leaves
    from devit_tpu_torch.parallel.serve import (make_collaborative_server, placement,
                                                serving_devices)

    cfg = get_vit_config("dedeit", **TINY)
    backbone = VisionTransformer(cfg, dtype=torch.float32)
    tree = stacked_vit_to_jax_params(
        init_multivit(backbone, [torch.Generator().manual_seed(10 + d) for d in range(D)]))
    rng = np.random.default_rng(0)
    fused_cms, served_cms = [], []
    for d in range(D):
        params = map_leaves(lambda a: np.asarray(a)[d], tree)
        g = build_gates(np.stack([rng.permutation(cfg.hidden_dim) for _ in range(cfg.depth)]),
                        np.stack([rng.permutation(cfg.num_heads) for _ in range(cfg.depth)]),
                        [0.3] * cfg.depth, [0.25] * cfg.depth)
        for cms in (fused_cms, served_cms):
            cms.append(compact_vit_ragged(params, g, cfg, neuron_multiple=8, device=device))
    ens = EnsMLP(num_classes=5 * D, sub_size=64, num_divisions=D, teacher_size=128,
                 family="deit", dtype=torch.float32).reset_parameters(
        torch.Generator().manual_seed(2)).to(device)
    ev = {k: v.detach() for k, v in ens.named_parameters()}
    kw = dict(patch_size=cfg.patch_size, dtype=torch.float32,
              use_kernel=device.type == "cuda", fast_math=False)
    devices = serving_devices(device)
    serve = make_collaborative_server(served_cms,
                                      lambda e, c, t: functional_call(ens, e, (c, t)), ev,
                                      devices=devices, **kw)
    images = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        served = serve(ev, images).to(device)
        fused = ens(*stack_division_features(fused_cms, images.to(device), **kw)).logits
    batches = [images, images.flip(1), images.flip(2)]
    streamed = list(serve.stream(ev, batches, depth=2))
    s_err = max(float(np.abs(got - serve(ev, b).float().cpu().numpy()).max())
                for got, b in zip(streamed, batches))
    return dict(err=float((served - fused).abs().max()), stream_err=s_err, serve=serve,
                devices=devices, n_placement=placement(D, [torch.device(device.type, i) for i in range(n)]))


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """One stage-5 step (with the stage-2 and DEKD steps) over n_devices
    ranks on `device` (the card unless the caller asks for the CPU; ranks
    that share a card join over gloo, NCCL refusing them), each loss held to
    the one-process step's at 1e-5 relative, then the serving topology
    (module docstring). Prints `dryrun_multichip(n): layout={...} loss=...
    OK`; raises on a mismatch."""
    from devit_tpu_torch.parallel.launch import run_ranks

    dev = resolve_device(device)
    env = ({"DEVIT_DIST_BACKEND": "gloo"}
           if dev.type == "cuda" and torch.cuda.device_count() < n_devices else None)
    ranks = run_ranks("devit_tpu_torch.entry:_dryrun_steps", n_devices,
                      args=(n_devices, True, dev.type), device=dev.type, env=env, timeout=600)
    one = _dryrun_steps(n_devices, parallel=False, device=dev)
    got = ranks[0]
    for k in ("loss", "stage2", "dekd", "q_loss"):
        if not math.isfinite(got[k]):
            raise RuntimeError(f"dryrun {k}: non-finite {got[k]}")
        if any(abs(r[k] - one[k]) > 1e-5 * max(abs(one[k]), 1e-6) for r in ranks):
            raise RuntimeError(f"dryrun {k}: ranks {[r[k] for r in ranks]} vs one process "
                               f"{one[k]}")
    where = f"{dev.type}, {n_devices} processes"
    print(f"dryrun_multichip({n_devices}): layout={got['shape']} loss={got['loss']:.4f} OK "
          f"({where})")
    print(f"dryrun stage-2 data-parallel: layout={{'data': {n_devices}}} "
          f"loss={got['stage2']:.4f} OK")
    print(f"dryrun stage-4 DEKD data-parallel: layout={{'data': {n_devices}}} "
          f"loss={got['dekd']:.4f} q={got['q_loss']:.4f} OK")
    D = _num_divisions(n_devices)
    topo = _serving_topology(D, n_devices, dev)
    serve = topo["serve"]
    n_used = len(set(serve.division_devices))
    divs, fusion = topo["n_placement"]
    if topo["err"] >= 1e-4 or topo["stream_err"] >= 1e-4:
        raise RuntimeError(f"serving topology: max|served - fused| {topo['err']}, stream "
                           f"{topo['stream_err']}")
    if n_used != min(D, len(topo["devices"])):
        raise RuntimeError(f"serving topology: divisions on {n_used} devices")
    if len(set(divs)) != min(D, n_devices) or (n_devices > D) == (fusion in divs):
        raise RuntimeError(f"placement on {n_devices} devices: divisions on {divs}, fusion on "
                           f"{fusion}")
    print(f"dryrun serving topology: {D} divisions on {n_used} device(s) here, fusion on "
          f"{serve.fusion_device}, max|d| vs single-device fused = {topo['err']:.2e}; stream "
          f"depth 2 matches per-batch serving (max|d| {topo['stream_err']:.2e}); on "
          f"{n_devices} devices the divisions take {len(set(divs))}, the fusion "
          f"{'a spare one' if fusion not in divs else 'the first'} ({fusion}) OK")


if __name__ == "__main__":
    dryrun_multichip(8)

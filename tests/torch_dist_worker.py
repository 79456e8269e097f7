"""Rank-side scenarios of the port's multi-process tests (the part
tests/multihost_worker.py plays for the JAX package). Not a test file.

Each scenario takes a `spec` dict of numpy inputs (weights in the JAX
package's trees, batches, step options), builds the port's models on the
CPU, and runs the steps under the data or ensemble layout of the process
group it finds; with parallel=False it runs the same code in one process,
the one-rank reference. Results are numpy dicts keyed by parameter name:

    devit_tpu_torch.parallel.launch.run_ranks(
        "tests/torch_dist_worker.py:stage2", 2, args=(spec,))
"""

import numpy as np
import torch

from devit_tpu_torch.configs import get_cct_config, get_vit_config
from devit_tpu_torch.data import mixup as tmix
from devit_tpu_torch.io.bridge import (
    ensmlp_from_jax_params, stacked_vit_from_jax_params, vit_from_jax_params,
)
from devit_tpu_torch.models.cct import CCT
from devit_tpu_torch.models.ensemble import EnsembleCCT, EnsMLP, init_multivit
from devit_tpu_torch.models.vit import Gates, VisionTransformer
from devit_tpu_torch.parallel import mesh as M
from devit_tpu_torch.train import optim as toptim
from devit_tpu_torch.train import steps as S
from devit_tpu_torch.train.state import TrainState


def _np(values) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in values.items()}


def _vit(name, overrides, params=None, seed=0):
    cfg = get_vit_config(name, **overrides)
    if params is not None:
        return vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32)
    return VisionTransformer(cfg, dtype=torch.float32).reset_parameters(
        torch.Generator().manual_seed(seed))


_DRAWS = (tmix._params, tmix._sample_box)


def _mixup(spec):
    """MixupConfig of the spec, with timm's draws fixed where the spec fixes
    them (JAX draws other numbers from the same seed)."""
    tmix._params, tmix._sample_box = _DRAWS
    if spec.get("mixup") is None:
        return None
    fixed = spec.get("mixup_fixed")
    if fixed is not None:
        lam, cut, box = fixed
        tmix._params = lambda g, c, shape=(): (torch.tensor(lam), torch.tensor(cut))
        tmix._sample_box = lambda g, h, w, l, c: tuple(torch.tensor(v, dtype=torch.int32)
                                                       for v in box)
    return tmix.MixupConfig(**spec["mixup"])


def _recorded(state, sink):
    """The state's optimizer hands the gradients it receives to `sink`."""
    update = state.tx.update

    def rec(g, s, p):
        sink.append({k: v.clone() for k, v in g.items()})
        return update(g, s, p)

    state.tx.update = rec
    return state


def _tx(spec):
    return toptim.make_optimizer(toptim.OptimConfig(**spec["opt"]), 2)


def _layout(parallel: bool, num_divisions: int = 0):
    if not parallel:
        return None
    return M.ensemble_layout(num_divisions) if num_divisions else M.data_layout()


def stage2(spec: dict, parallel: bool = True) -> dict:
    """Stage-2 (spec["kind"] "stage2") or DEKD ("dekd") steps, then one eval
    batch; the first step's gradients, the metrics, parameters and EMA."""
    layout = _layout(parallel)
    model = _vit(*spec["student"])
    teacher = _vit(*spec["teacher"]) if spec.get("teacher") else None
    state = TrainState.create(model, _tx(spec), use_ema=True, ema_decay=spec["ema"])
    grads = []
    _recorded(state, grads)
    kw = dict(spec["kw"], mixup=_mixup(spec), layout=layout)
    gates = None
    if spec["kind"] == "dekd":
        gates = Gates(*map(torch.from_numpy, spec["gates"]))
        step = S.make_dekd_step(model, teacher, **kw)
        run = lambda st, x, y, g: step(st, None, gates, x, y, g)
    else:
        step = S.make_stage2_step(model, teacher, **kw)
        run = lambda st, x, y, g: step(st, None, x, y, g)
    metrics = []
    for (x, y), seed in zip(spec["batches"], spec["seeds"]):
        state, m = run(state, torch.from_numpy(x), torch.from_numpy(y),
                       torch.Generator().manual_seed(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    ev = S.make_eval_step(model, layout)
    x, y = spec["eval_batch"]
    counters = ev(None, gates, torch.from_numpy(x), torch.from_numpy(y))
    return dict(metrics=metrics, grads=_np(grads[0]), params=_np(state.params),
                ema=_np(state.ema_params), eval={k: float(v) for k, v in counters.items()},
                shape=None if layout is None else layout.shape)


def _stage5_models(spec):
    D = spec["D"]
    if spec["family"] == "cct":
        name, overrides = spec["backbone"]
        cfg = get_cct_config(name.replace("decct", "cct", 1), backbone=True, **overrides)
        backbone = CCT(cfg, dtype=torch.float32)
        stacked = init_multivit(backbone, [torch.Generator().manual_seed(s)
                                           for s in range(D)])
        ens = EnsembleCCT(num_classes=spec["num_classes"], sub_size=backbone.cfg.embed_dim,
                          num_divisions=D, dtype=torch.float32).reset_parameters(
            torch.Generator().manual_seed(D))
        return backbone, stacked, ens, None
    name, overrides = spec["backbone"]
    backbone = VisionTransformer(get_vit_config(name, **overrides), dtype=torch.float32)
    stacked = stacked_vit_from_jax_params(spec["stacked"], backbone, device="cpu")
    ens = ensmlp_from_jax_params(spec["ens"], num_divisions=D, dtype=torch.float32,
                                 device="cpu")
    teacher = _vit(*spec["teacher"]) if spec.get("teacher") else None
    return backbone, stacked, ens, teacher


def stage5(spec: dict, parallel: bool = True) -> dict:
    """Stage-5 steps of the ViT ("vit") or CCT ("cct") family with the
    division axis over the ensemble layout's ranks, then one eval batch.
    Parameters and gradients come back whole (gathered over the division
    group), in one process's layout."""
    D = spec["D"]
    layout = _layout(parallel, D)
    backbone, stacked, ens, teacher = _stage5_models(spec)
    bb = TrainState.create(stacked, _tx(spec), use_ema=True, ema_decay=spec["ema"])
    en = TrainState.create(ens, _tx(spec), use_ema=True, ema_decay=spec["ema"])
    gates = None
    if spec.get("gates") is not None:
        gates = Gates(*map(torch.from_numpy, spec["gates"]))
    if layout is not None:
        M.shard_state(bb, layout)
        if gates is not None:
            gates = Gates(*M.shard_division_tree(dict(zip(("head", "neuron"), gates)),
                                                 layout).values())
    bb_grads, ens_grads = [], []
    _recorded(bb, bb_grads)
    _recorded(en, ens_grads)
    cct = spec["family"] == "cct"
    make = S.make_cct_ensemble_train_step if cct else S.make_ensemble_train_step
    step = make(backbone, ens, teacher, mixup=_mixup(spec), layout=layout, **spec["kw"])
    metrics = []
    for (x, y), seed in zip(spec["batches"], spec["seeds"]):
        bb, en, m = step(bb, en, None, gates, torch.from_numpy(x), torch.from_numpy(y),
                         torch.Generator().manual_seed(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    ev = (S.make_cct_ensemble_eval_step if cct else S.make_ensemble_eval_step)(
        backbone, ens, layout)
    x, y = spec["eval_batch"]
    counters = ev(bb.params, None, gates, torch.from_numpy(x), torch.from_numpy(y))
    full = bb if layout is None else M.gathered_state(bb, layout)
    g0 = bb_grads[0] if layout is None else M.gather_division_tree(bb_grads[0], layout)
    return dict(metrics=metrics, bb_grads=_np(g0), ens_grads=_np(ens_grads[0]),
                bb_params=_np(full.params), bb_ema=_np(full.ema_params),
                ens_params=_np(en.params), eval={k: float(v) for k, v in counters.items()},
                shape=None if layout is None else layout.shape,
                divisions=None if layout is None else list(layout.divisions))


def run_all(specs: dict, parallel: bool = True) -> dict:
    """stage2 over each {name: spec} in turn (one launch for several)."""
    return {name: stage2(spec, parallel) for name, spec in specs.items()}


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    from devit_tpu_torch import runtime

    if runtime.rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


def sleep_past_the_timeout():
    """Every rank waits far longer than the launch's timeout."""
    import time

    time.sleep(600)


TOY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4, num_classes=5)


def small_specs() -> dict:
    """A stage-2 and a stage-5 spec at a toy width, weights drawn by the
    port's initializers (as the JAX package's trees)."""
    from devit_tpu_torch.io.bridge import (
        ensmlp_to_jax_params, stacked_vit_to_jax_params, vit_to_jax_params,
    )

    rng = np.random.default_rng(0)

    def batch(n):
        return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 5, n).astype(np.int64))

    opt = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3)
    model = _vit("dedeit", TOY, seed=1)
    s2 = dict(kind="stage2", student=("dedeit", dict(TOY, drop_path_rate=0.1),
                                      vit_to_jax_params(model)),
              opt=opt, ema=0.9, batches=[batch(8)], seeds=[0], eval_batch=batch(8),
              kw=dict(smoothing=0.1))
    backbone = VisionTransformer(get_vit_config("dedeit", **TOY), dtype=torch.float32)
    stacked = init_multivit(backbone, [torch.Generator().manual_seed(s) for s in (2, 3)])
    ens = EnsMLP(num_classes=5, sub_size=32, num_divisions=2, dtype=torch.float32,
                 family="deit").reset_parameters(torch.Generator().manual_seed(4))
    s5 = dict(family="vit", D=2, backbone=("dedeit", TOY),
              stacked=stacked_vit_to_jax_params(stacked), ens=ensmlp_to_jax_params(ens),
              opt=dict(opt, clip_grad=0.05), ema=0.9, batches=[batch(8)], seeds=[1],
              eval_batch=batch(8), kw=dict(smoothing=0.1, distillation_type="none"))
    return {"stage2": s2, "stage5": s5}


def rendezvous(specs: dict, parallel: bool = True) -> dict:
    """The numbers tests/test_runtime.py's worker prints for the JAX
    package: the stage-2 loss, its eval counters, the stage-5 loss."""
    from devit_tpu_torch import runtime

    s2 = stage2(specs["stage2"], parallel)
    s5 = stage5(specs["stage5"], parallel)
    return {"world": runtime.world_size(), "stage2_loss": s2["metrics"][0]["loss"],
            **{f"eval_{k}": v for k, v in s2["eval"].items()},
            "stage5_loss": s5["metrics"][0]["loss"]}


def cli(argv: list, epochs_first_run: int = 0) -> int:
    """The port's CLI on this rank (`--device cpu`). epochs_first_run > 0
    stops fit after that many epochs: the crash a resume starts from."""
    from devit_tpu_torch.cli import stages
    from devit_tpu_torch.cli.__main__ import main

    torch.set_num_threads(1)
    if epochs_first_run:
        real_fit = stages.fit
        stages.fit = lambda *a, **kw: real_fit(*a, **dict(kw, epochs=epochs_first_run))
    return main(list(argv) + ["--device", "cpu"])

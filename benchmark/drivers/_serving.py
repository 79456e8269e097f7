"""What the two serving drivers share: the deployed ensemble built from the
seed and served through the port's engine and batcher, the sample of
answered requests the reference checks, and what the per-layer readers
read.

The program under test gets the full-width division weights and the binary
gates, and compacts them itself (`compact_vit_ragged`); the EnsMLP head
gets its weights; `InferenceEngine` serves them behind `MicroBatcher`. The
reference gets the same weights and gates and gates the full-width model.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import core, weights
from benchmark.reference import model as ref


def leaf_sets(cfg: dict) -> Tuple[Dict[str, tuple], int]:
    """Shapes of every division's leaves and the fusion head's, in the one
    flat draw: ({"div<d>.<leaf>" and "ens.<leaf>": shape}, divisions)."""
    D = cfg["divisions"]
    shapes = {}
    for d in range(D):
        shapes.update({f"div{d}.{k}": s for k, s in ref.leaf_shapes(cfg, with_head=False).items()})
    ens = ref.ensmlp_shapes(cfg["ensemble"], cfg["embed_dim"], D)
    shapes.update({f"ens.{k}": s for k, s in ens.items()})
    return shapes, D


def split(leaves: dict, D: int) -> Tuple[List[dict], dict]:
    divs = [{k[len(f"div{d}."):]: v for k, v in leaves.items() if k.startswith(f"div{d}.")}
            for d in range(D)]
    return divs, {k[4:]: v for k, v in leaves.items() if k.startswith("ens.")}


def gates(cfg: dict, seed: int):
    g = ref.geometry(cfg)
    return weights.policy_gates(cfg["policy"], g["L"], g["H"], g["hidden"], seed)


@dataclasses.dataclass
class Served:
    engine: object
    batcher: object
    pool: np.ndarray
    calls: List[Tuple[float, float, int]]  # predict calls: (start, end, rows)


def build(cell: core.Cell, spans: core.Spans) -> Served:
    """The port's serving stack over the seeded ensemble, warmed up, with its
    batcher running. Every predict call is recorded with its rows and timed
    as a host span."""
    from devit_tpu_torch.configs import get_vit_config
    from devit_tpu_torch.models.compact_vit import compact_vit_ragged
    from devit_tpu_torch.models.ensemble import EnsMLP
    from devit_tpu_torch.models.vit import Gates
    from devit_tpu_torch.serving.daemon import InferenceEngine, MicroBatcher, ServeConfig

    cfg, dev = cell.config, torch.device(cell.device)
    srv = cfg["serving"]
    t_start = time.perf_counter()
    shapes, D = leaf_sets(cfg)
    divs, ens_leaves = split(weights.seeded_leaves(shapes, cell.seed, dev, host=True), D)
    vcfg = get_vit_config(cfg["model"], img_size=cfg["img_size"], patch_size=cfg["patch_size"],
                          embed_dim=cfg["embed_dim"], depth=cfg["depth"],
                          num_heads=cfg["num_heads"], mlp_ratio=cfg["mlp_ratio"],
                          num_classes=cfg["num_classes"], distilled=cfg["distilled"],
                          layer_norm_eps=cfg["layer_norm_eps"])
    cms = [compact_vit_ragged(weights.flax_tree(p, cfg["depth"]), Gates(head=h, neuron=n), vcfg,
                              neuron_multiple=cfg["neuron_multiple"], device=dev)
           for p, (h, n) in zip(divs, gates(cfg, cell.seed))]
    e = cfg["ensemble"]
    dtype = getattr(torch, srv["dtype"])
    ens = EnsMLP(num_classes=e["num_classes"], sub_size=cfg["embed_dim"], num_divisions=D,
                 teacher_size=e["teacher_size"], family=e["family"], dtype=dtype)
    names = sorted({k.split(".")[0] for k in ens_leaves})
    ens.load_params({n: {"kernel": ens_leaves[f"{n}.kernel"], "bias": ens_leaves[f"{n}.bias"]}
                     for n in names})
    engine = InferenceEngine(
        cms, ens.to(dev),
        ServeConfig(input_size=cfg["img_size"], patch_size=cfg["patch_size"],
                    buckets=tuple(srv["buckets"]), max_wait_ms=srv["max_wait_ms"], dtype=dtype,
                    use_kernel=srv["use_kernel"], fast_math=srv["fast_math"]),
        device=dev)
    t_warm = time.perf_counter()
    warm_s = engine.warm_up()
    cell.log(f"set-up: weights, compaction and engine {t_warm - t_start:.3f} s, "
             f"warm-up {warm_s:.3f} s")
    calls: List[Tuple[float, float, int]] = []
    predict = engine.predict

    def traced_predict(images_u8):
        t0 = time.perf_counter()
        try:
            return spans.span("predict", predict, images_u8)
        finally:
            calls.append((t0, time.perf_counter(), images_u8.shape[0]))

    engine.predict = traced_predict
    pool = weights.image_pool(cell.traffic["pool_images"], cfg["img_size"], cell.seed, dev)
    served = Served(engine=engine, batcher=MicroBatcher(engine).start(), pool=pool, calls=calls)
    core.settle()
    return served


def padded_rows(rows: int, buckets) -> int:
    """Rows a predict call of `rows` images runs: chunks of the largest
    bucket, each padded up to the smallest bucket that holds it."""
    cap, out = max(buckets), 0
    for s in range(0, rows, cap):
        n = min(cap, rows - s)
        out += min(b for b in buckets if b >= n)
    return out


def sample(requests: List[tuple], count: int, seed: int) -> List[tuple]:
    """`count` answered requests drawn from the seed, the largest among them."""
    answered = [r for r in requests if r[-1] is not None]
    if not answered:
        return []
    rng = np.random.default_rng(weights.sub_seed(seed, "sample"))
    largest = max(range(len(answered)), key=lambda i: answered[i][1])
    rest = [i for i in range(len(answered)) if i != largest]
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [answered[largest]] + [answered[rest[i]] for i in sorted(pick)]


def check(cell: core.Cell, chosen: List[tuple], pool: np.ndarray,
          prec: str = "f32") -> Dict[str, float]:
    """The numbers compared with the reference over the sampled requests
    (offset, rows, sent, answered, logits): logit_err, the largest gap between a served
    logit and the reference's, over the reference logits' RMS. With
    prec="fp8" the reference in float8 stands in the program's place (the
    control)."""
    if not chosen:
        return {"logit_err": math.inf}
    dev = torch.device(cell.device)
    ref.set_strict_f32()
    shapes, D = leaf_sets(cell.config)
    divs, ens = split(weights.seeded_leaves(shapes, cell.seed, dev), D)
    gts = [(torch.from_numpy(h).to(dev), torch.from_numpy(n).to(dev))
           for h, n in gates(cell.config, cell.seed)]
    images = torch.from_numpy(np.concatenate([pool[r[0]:r[0] + r[1]] for r in chosen])).to(dev)
    want = ref.ensemble_logits(divs, gts, ens, images, cell.config)
    if prec != "f32":
        got = ref.ensemble_logits(divs, gts, ens, images, cell.config, prec=ref.Precision(prec))
    else:
        got = torch.from_numpy(np.concatenate([r[-1] for r in chosen])).to(dev).float()
    if got.shape != want.shape:
        return {"logit_err": math.inf}
    rms = want.square().mean().sqrt()
    return {"logit_err": float((got - want).abs().max() / rms)}


def context(cell: core.Cell, served: Served, t0: float, t1: float, snap0: dict, snap1: dict,
            images: int, trace) -> dict:
    """What the serving cells' per-layer readers read."""
    calls = [c for c in served.calls if t0 <= c[0] and c[1] <= t1]
    return {"config": cell.config, "traffic": cell.traffic, "window_s": t1 - t0,
            "images": images, "batcher": (snap0, snap1),
            "calls": calls, "buckets": tuple(cell.config["serving"]["buckets"]), "trace": trace}


def peak_bytes(device: str) -> int:
    return int(torch.cuda.max_memory_allocated()) if device.startswith("cuda") else 0


def release(served: Served) -> None:
    served.batcher.stop()
    served.engine.predict = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

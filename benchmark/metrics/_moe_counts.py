"""Operations and bytes of a sparse-expert ViT's work (V-MoE), counted from
the shapes, and the readers' shared pieces: the device time of the kernels
launched inside the program's MoE spans a traced step, the route counters'
dropped share.

A forward counts the dense layers' products, K expert MLPs a token in a MoE
layer (the work the routing asks for; the slots past an expert's fill,
which the program computes and never combines, are not counted) and the
router's product. Bytes count 2 a bf16 value and 4 an index or f32 weight,
each read or written once; a row read for a kept choice counts once a
choice; under remat the dispatch and the combine run forward twice (the
forward and the backward's recompute), and both passes count. Every reader returns None, and raises nothing, where the run has
no MoE configuration, no trace, no span or no counter to read.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from benchmark.metrics._counts import BF16, HBM_BYTES_PER_S, _layer_flops
from benchmark.reference.model import geometry

INDEX = 4  # an int32 map entry or an f32 weight
SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")  # models/moe.py's


def is_moe(cfg: Optional[dict]) -> bool:
    return bool(cfg and cfg.get("moe_layers"))


def flops_per_image(cfg: dict) -> float:
    """One image's forward: patch embedding, attention halves, dense MLPs,
    K experts a token and the router in the MoE layers, the head."""
    g = geometry(cfg)
    N, C, dh, H, hid = g["N"], g["C"], g["dh"], g["H"], g["hidden"]
    moe = len(cfg["moe_layers"])
    mlp = 4 * N * C * hid
    return float(2 * (N - g["prefix"]) * g["P"] * g["P"] * 3 * C
                 + g["L"] * _layer_flops(N, C, dh, H, 0)
                 + (g["L"] - moe) * mlp
                 + moe * (cfg["top_k"] * mlp + 2 * N * C * cfg["num_experts"])
                 + 2 * C * g["K"])


def group(cfg: dict, batch: int):
    """(tokens T, choices a token K, slots S, width C) of a MoE layer's
    group at `batch` images."""
    g = geometry(cfg)
    T, K, E = batch * g["N"], cfg["top_k"], cfg["num_experts"]
    cap = int(round(K * T * cfg["capacity_ratio"] / E))
    return T, K, E * cap, g["C"]


def forward_passes(cfg: dict) -> int:
    """Times a step runs a MoE layer's forward: twice under remat."""
    return 2 if cfg.get("use_remat") else 1


def gather_bytes(cfg: dict, batch: int, kept_share: float) -> float:
    """One step's least bytes of the gather kernels, all MoE layers: the
    dispatch in each forward pass (kept rows of h read, every slot written,
    the slot map) and the combine's backward into the slots (kept rows of
    dy read, every slot written, the slot map, each choice's slot and
    weight)."""
    T, K, S, C = group(cfg, batch)
    kept = kept_share * T * K
    dispatch = kept * C * BF16 + S * C * BF16 + S * INDEX
    weighted = kept * C * BF16 + S * C * BF16 + S * INDEX + 2 * T * K * INDEX
    return len(cfg["moe_layers"]) * (forward_passes(cfg) * dispatch + weighted)


def combine_bytes(cfg: dict, batch: int, kept_share: float) -> float:
    """One step's least bytes of the combine kernels, all MoE layers: the
    combine in each forward pass (kept rows read, weights and slots, y
    written), the dispatch's
    backward (kept rows of the slots' gradient read, slots, dx written) and
    the weights' gradient (dy and the kept rows read, slots, dw written)."""
    T, K, S, C = group(cfg, batch)
    kept = kept_share * T * K
    rows = kept * C * BF16
    forward = rows + 2 * T * K * INDEX + T * C * BF16
    dx = rows + T * K * INDEX + T * C * BF16
    dw = T * C * BF16 + rows + 2 * T * K * INDEX
    return len(cfg["moe_layers"]) * (forward_passes(cfg) * forward + dx + dw)


def kept_share(ctx) -> Optional[float]:
    """Kept token-choices over routed ones in the window's route counters."""
    counts = ctx.get("route_counts") or {}
    routed = sum(c["routed"] for c in counts.values())
    if not routed:
        return None
    return 1.0 - sum(c["dropped"] for c in counts.values()) / routed


def launched_in(events: Iterable, names) -> Dict[str, float]:
    """{name: device seconds of the kernels launched inside the profiler
    ranges of that name} over a profiler's events (torch.profiler's
    FunctionEvents, each CPU operation holding the kernels the profiler
    linked to it by their launch, and its child operations). A kernel
    counts by where the host launched it, so the device's waits on the
    host's enqueue stay out."""
    def device_us(e) -> float:
        return (sum(k.duration for k in getattr(e, "kernels", ()))
                + sum(device_us(c) for c in getattr(e, "cpu_children", ())))

    out: Dict[str, float] = {}
    for e in events:
        if e.name in names:  # the MoE spans do not nest in one another
            out[e.name] = out.get(e.name, 0.0) + 1e-6 * device_us(e)
    return out


def span_ms_per_step(ctx, names) -> Optional[float]:
    """Device ms a traced step of the kernels launched inside the program's
    spans `names` (the forward's and remat's recompute alike)."""
    steps, got = ctx.get("traced_steps"), ctx.get("moe_span_kernel_s")
    if not steps or not got or not is_moe(ctx.get("config")):
        return None
    seen = [got[n] for n in names if n in got]
    return 1e3 * sum(seen) / steps if seen else None


def roofline(ctx, mark: str, nbytes) -> Optional[float]:
    """Percent: the traced steps' least time of the kernels whose names hold
    `mark` (nbytes(cfg, batch, kept share) a step at the card's bandwidth)
    over their device time."""
    tr, cfg = ctx.get("trace"), ctx.get("config")
    share = kept_share(ctx)
    if tr is None or not ctx.get("traced_steps") or not is_moe(cfg) or share is None:
        return None
    spent = sum(e - s for n, s, e in tr.ops_in(tr.lo, tr.hi) if mark in n)
    if spent <= 0:
        return None
    bound = ctx["traced_steps"] * nbytes(cfg, ctx["batch"], share) / HBM_BYTES_PER_S
    return 100.0 * bound / spent

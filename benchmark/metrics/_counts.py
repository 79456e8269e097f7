"""Operations and bytes of the work a cell needs, counted from the shapes,
and the card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit).

Operations count 2 per multiply-add. An attention call's bytes count each
input byte read once and each output byte written once.
"""

from __future__ import annotations

from benchmark.reference.model import geometry

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def compact_widths(cfg: dict):
    """(kept heads, MLP width) of every division's layers as the compaction
    runs them: a layer with no head keeps one zero head, the MLP width is
    padded to a multiple of `neuron_multiple`."""
    g = geometry(cfg)
    return [[(min(max(kh, 1), g["H"]),
              max(min(_round_up(kn, cfg["neuron_multiple"]), g["hidden"]), 1))
             for kh, kn in zip(hrow, nrow)]
            for hrow, nrow in zip(cfg["policy"]["heads"], cfg["policy"]["neurons"])]


def _layer_flops(N: int, C: int, dh: int, kh: int, kn: int) -> int:
    width = kh * dh
    return 2 * N * C * 3 * width + 4 * N * N * width + 2 * N * width * C + 4 * N * C * kn


def ensemble_flops_per_image(cfg: dict) -> float:
    """One image through the compacted divisions and the EnsMLP fusion."""
    g = geometry(cfg)
    N, C, dh = g["N"], g["C"], g["dh"]
    flops = 0
    for layers in compact_widths(cfg):
        flops += 2 * (N - g["prefix"]) * g["P"] * g["P"] * 3 * C
        flops += sum(_layer_flops(N, C, dh, kh, kn) for kh, kn in layers)
    e = cfg["ensemble"]
    fused = cfg["divisions"] * C
    branches = 2 if e["family"] == "deit" else 1
    flops += branches * 2 * (fused * e["teacher_size"] + e["teacher_size"] * e["num_classes"])
    return float(flops)


def vit_flops_per_image(cfg: dict) -> float:
    """One image's forward through the full-width (De)ViT and its heads."""
    g = geometry(cfg)
    N, C, dh = g["N"], g["C"], g["dh"]
    heads = 2 if cfg["distilled"] else 1
    return float(2 * (N - g["prefix"]) * g["P"] * g["P"] * 3 * C
                 + g["L"] * _layer_flops(N, C, dh, g["H"], g["hidden"])
                 + heads * 2 * C * g["K"])


def attention_fwd_bound_s(B: int, N: int, kh: int, dh: int, elem: int = BF16) -> float:
    """Least time of one attention forward: q, k, v read and the output
    written once, against the two products."""
    nbytes = 4 * B * N * kh * dh * elem
    flops = 4 * B * N * N * kh * dh
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def attention_bwd_bound_s(B: int, N: int, kh: int, dh: int, elem: int = BF16) -> float:
    """Least time of one attention backward: q, k, v and the output's
    gradient read, dq, dk, dv written once (7 B N C elements), against
    recomputing the scores and the four products of dv, dp, dq, dk."""
    C = kh * dh
    return max(7 * B * N * C * elem / HBM_BYTES_PER_S, 10 * B * N * N * C / PEAK_BF16_FLOPS)


def ensemble_attention_bound_s(cfg: dict, rows: int) -> float:
    """Least attention time of one forward of `rows` rows."""
    g = geometry(cfg)
    return sum(attention_fwd_bound_s(rows, g["N"], kh, g["dh"])
               for layers in compact_widths(cfg) for kh, _ in layers)


def train_attention_bound_s(cfg: dict, batch: int) -> float:
    """Least attention time of one training step: one forward and one
    backward a layer (a recompute under remat is not needed work)."""
    g = geometry(cfg)
    return g["L"] * (attention_fwd_bound_s(batch, g["N"], g["H"], g["dh"])
                     + attention_bwd_bound_s(batch, g["N"], g["H"], g["dh"]))

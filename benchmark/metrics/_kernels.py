"""Device kernels by class, and the time the device was busy.

Attention kernels are told by name: the port's own (every `attn_*` kernel:
the forward and backward, f32 and bf16, long, wide and split) and the
library's (`flash`, `fmha`, `sdpa`), so the same work is read whatever
implements it. Matrix products are cuBLAS's and CUTLASS's kernels and the
port's int8 product. Copies and memsets are device operations of their own.
Everything else is a plain op: LayerNorm, GELU, bias and residual adds,
casts, reductions.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

ATTENTION = ("attn_", "flash", "fmha", "sdpa", "attention")
GEMM = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "wgmma", "s16816", "h16816",
        "quant_mma", "quant_rows")
COPY = ("memcpy", "memset")

Interval = Tuple[float, float]


def kind(name: str) -> str:
    """"copy", "attention", "gemm" or "other" for a device operation's name."""
    low = name.lower()
    if any(p in low for p in COPY):
        return "copy"
    if any(p in low for p in ATTENTION):
        return "attention"
    if any(p in low for p in GEMM):
        return "gemm"
    return "other"


def merged(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of `intervals`, clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Interval] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of `intervals` inside [lo, hi]."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of [lo, hi]: where no interval runs."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out

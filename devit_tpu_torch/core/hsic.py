"""HSIC (Hilbert-Schmidt Independence Criterion) for importance ranking
(counterpart of devit_tpu/core/hsic.py:22-88).

Multi-bandwidth Gaussian kernel over X (sigma in {1, 2, 4, 8, 16}, averaged),
linear or RBF kernel over Y, double-centred Gram matrices,
score = trace(G_X @ G_Y).

The candidate axis is a tensor axis: a layer's neurons or heads score in one
batched product (`bmm` to (C, B, B) grams), with no Python loop over
candidates. These are plain f32 products; `f32_matmul()` keeps TF32 off
them whatever the process-wide flag says, since TF32 moves the scores by
about 1e-3 and reorders near ties.
"""

from __future__ import annotations

import contextlib

import torch

SIGMAS = (1.0, 2.0, 4.0, 8.0, 16.0)


@contextlib.contextmanager
def f32_matmul():
    """Full-f32 matrix products (no TF32) inside the block; the flag is
    restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or left in f64: the scores run in f32, and f64 inputs give
    the same computation in f64 (a reference for the f32 rounding)."""
    return x if x.dtype == torch.float64 else x.float()


def _center(g: torch.Tensor) -> torch.Tensor:
    """Double-centre Gram matrices (..., B, B)."""
    mean_col = g.mean(dim=-2, keepdim=True)
    mean_row = g.mean(dim=-1, keepdim=True)
    return g - mean_col - mean_row + g.mean(dim=(-2, -1), keepdim=True)


def _sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between rows: (..., B, F) -> (..., B, B).

    The rows are centred first. That leaves every distance as it is, but
    norms + norms - 2 * inner cancels the rows' common offset: after
    `_mean_sub` (which shifts each column by mean/std) it is large against
    the distances, and f32 then loses three to four digits, so two summation
    orders (the card's against the CPU's) disagree by about 1e-3 of the
    scores on a real model's activations. Centred, they agree to about 1e-6.
    """
    x = x - x.mean(dim=-2, keepdim=True)
    inner = torch.matmul(x, x.transpose(-1, -2))
    norms = torch.diagonal(inner, dim1=-2, dim2=-1)
    return norms.unsqueeze(-2) + norms.unsqueeze(-1) - 2.0 * inner


def multi_gaussian_gram(x: torch.Tensor) -> torch.Tensor:
    """Average of Gaussian kernels over SIGMAS: (..., B, F) -> (..., B, B)."""
    d2 = _sq_dists(x)
    g = torch.zeros_like(d2)
    for s in SIGMAS:
        g = g + torch.exp(-d2 / (2.0 * s * s))
    return g / len(SIGMAS)


def linear_gram(x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, x.transpose(-1, -2))


def _mean_sub(x: torch.Tensor) -> torch.Tensor:
    """The reference's mean_sub expression verbatim: x - mean(x, 0) /
    (std(x, 0) + 1e-12). The division binds to the mean term only, and the
    std is the unbiased one (correction=1). Over the batch axis, -2."""
    return x - x.mean(dim=-2, keepdim=True) / (
        torch.std(x, dim=-2, correction=1, keepdim=True) + 1e-12)


def _gram_x(x: torch.Tensor, mean_sub: bool) -> torch.Tensor:
    x = at_least_f32(x)
    return _center(multi_gaussian_gram(_mean_sub(x) if mean_sub else x))


def _gram_y(y: torch.Tensor, y_kernel: str, mean_sub: bool) -> torch.Tensor:
    y = at_least_f32(y)
    if mean_sub:
        y = y - y.mean(dim=-2, keepdim=True)
    if y_kernel == "linear":
        return _center(linear_gram(y))
    if y_kernel == "rbf":
        return _center(multi_gaussian_gram(y))
    raise ValueError(y_kernel)


def hsic(x: torch.Tensor, y: torch.Tensor, *, y_kernel: str = "linear",
         mean_sub: bool = False) -> torch.Tensor:
    """HSIC score between features x (B, Fx) and y (B, Fy), a 0-d f32 tensor.

    y_kernel='linear', mean_sub=True  -> relevance
    y_kernel='rbf',    mean_sub=False -> redundancy
    """
    with f32_matmul():
        g_x = _gram_x(x, mean_sub)
        g_y = _gram_y(y, y_kernel, mean_sub)
        # trace(G_X @ G_Y) without forming the product
        return torch.sum(g_x * g_y.transpose(-1, -2))


def hsic_relevance_many(xs: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """HSIC(x_i, softmax probs) for each candidate x_i: (C, B, F) x (B, K)
    -> (C,). The probs gram is computed once."""
    with f32_matmul():
        g_x = _gram_x(xs, mean_sub=True)  # (C, B, B)
        g_y = _gram_y(probs, "linear", mean_sub=True)  # (B, B)
        return torch.sum(g_x * g_y.transpose(-1, -2), dim=(-2, -1))


def hsic_redundancy_matrix(xs: torch.Tensor) -> torch.Tensor:
    """Pairwise RBF-HSIC between candidates: (C, B, F) -> (C, C)."""
    with f32_matmul():
        g = _gram_x(xs, mean_sub=False)  # (C, B, B), centred
        return torch.einsum("aij,bji->ab", g, g)

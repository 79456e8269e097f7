"""MACs-constrained sparsity-policy search (counterpart of
devit_tpu/core/shrink.py).

Rejection-sample per-layer sparsity vectors whose analytic MACs land within
2% of shrink_ratio * 9.19 GMACs (the reference's dedeit anchor), evaluate
each candidate's gated top-1 on the validation set, and return (policies,
accuracies) for the next stage to argmax over.

The JAX package vmaps the forward over a chunk of candidate gates. Here the
candidate axis is folded into the batch, candidate-major (row c * B + b),
with one gate row per batch row: one forward of C * B rows per chunk and val
batch, so the attention kernel sees all C * B rows in each launch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from devit_tpu_torch.core.metrics import cal_shrink_macs
from devit_tpu_torch.core.rank import build_gates
from devit_tpu_torch.data.datasets import pad_batch_to_steady
from devit_tpu_torch.models.vit import Gates
from devit_tpu_torch.parallel.mesh import batch_rows


def screen(
    macs_target: float,
    population: int,
    lb: float,
    ub: float,
    layer: int,
    *,
    emb: int = 384,
    head: int = 6,
    seq_length: int = 197,
    mlp_ratio: float = 4,
    seed: Optional[int] = None,
    log=None,
) -> list:
    """Rejection-sample `population` sparsity vectors (2*layer dims) whose MACs
    are within 2% of macs_target. Same generator and draw order as the JAX
    package, so a seed gives the same policies."""
    rng = np.random.default_rng(seed)
    res: list = []
    n_params = layer * 2
    max_tries = max(population * 200000, 1000000)
    tries = 0
    while len(res) < population:
        tries += 1
        if tries > max_tries:
            full = cal_shrink_macs([0.0] * layer, [0.0] * layer, emb=emb,
                                   mlp_ratio=mlp_ratio, seq_length=seq_length,
                                   head=head, layer=layer)
            raise RuntimeError(
                f"screen(): no MACs-feasible policies after {tries} samples — "
                f"target {macs_target:.3f}G unreachable for this geometry "
                f"(full model = {full:.3f}G)")
        ratio = rng.uniform(lb, ub, size=(n_params,)).tolist()
        macs = cal_shrink_macs(
            neuron_sparsity=ratio[:layer], head_sparsity=ratio[layer:],
            emb=emb, mlp_ratio=mlp_ratio, seq_length=seq_length, head=head, layer=layer,
        )
        if abs(macs - macs_target) <= 0.02 * macs_target and ratio not in res:
            res.append(ratio)
            if log is not None:
                log.info(f"#samples: {len(res)}")
    return res


def random_point(macs_target, population, lb, ub, n_params, seed=None):
    """First feasible point."""
    return screen(macs_target, 1, lb, ub, n_params // 2, seed=seed)[0]


def policies_to_gates(
    policies: Sequence[Sequence[float]],
    neuron_rank: np.ndarray,
    head_rank: np.ndarray,
    layer: int,
) -> Gates:
    """Stack candidate policies into float32 numpy gates with a leading
    candidate axis: head (C, L, H), neuron (C, L, hidden)."""
    gates = [
        build_gates(neuron_rank, head_rank, p[:layer], p[layer : 2 * layer]) for p in policies
    ]
    return Gates(head=np.stack([g.head for g in gates]),
                 neuron=np.stack([g.neuron for g in gates]))


def fold_candidates(gates: Gates, images: torch.Tensor) -> Tuple[Gates, torch.Tensor]:
    """C candidates' gates (C, L, H) / (C, L, hidden) and a batch (B, ...) ->
    the gates with one row per batch row, (L, C*B, H) / (L, C*B, hidden), and
    the batch repeated C times, candidate-major: row c*B + b is image b under
    candidate c."""
    C, B = gates.head.shape[0], images.shape[0]

    def rows(g):
        g = torch.as_tensor(g, device=images.device).transpose(0, 1)  # (L, C, W)
        L, _, W = g.shape
        return g[:, :, None, :].expand(L, C, B, W).reshape(L, C * B, W)

    return Gates(rows(gates.head), rows(gates.neuron)), images.repeat(
        C, *([1] * (images.dim() - 1)))


def make_batched_policy_eval(model) -> Callable:
    """(stacked gates chunk (C, ...), images (B, ...), labels (B,)) ->
    per-candidate correct counts (C,), from one no_grad forward of `model` (a
    VisionTransformer) over the C*B folded rows."""

    def step(gates: Gates, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        C, B = gates.head.shape[0], images.shape[0]
        with torch.no_grad():
            folded, x = fold_candidates(gates, images)
            pred = model(x, folded).logits.argmax(dim=-1).view(C, B)
            return (pred == labels[None]).sum(dim=1)

    return step


def _device(model) -> torch.device:
    return next(model.parameters()).device


def evaluate_policies(
    model,
    stacked_gates: Gates,
    val_batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    *,
    candidate_chunk: int = 8,
    prepare: Optional[Callable] = None,
    layout=None,
) -> np.ndarray:
    """Top-1 accuracy (percent, float64) per candidate, chunked over
    candidates to bound activation memory.

    `val_batches` yields RAW HOST batches; the ragged final batch is padded
    to the steady shape (labels -1, which never match) before `prepare` (the
    eval transform, on a tensor on the model's device) runs. The candidate
    axis is padded to a chunk multiple with candidate 0's gates, so every
    chunk has one shape; the padded candidates' counts are sliced away.
    Under a data `layout` (parallel/mesh.Layout) each rank scores its rows
    of every padded batch and the counts are summed over the data group."""
    step = make_batched_policy_eval(model)
    device = _device(model)
    head = np.asarray(stacked_gates.head)
    neuron = np.asarray(stacked_gates.neuron)
    C = head.shape[0]
    C_pad = -(-C // candidate_chunk) * candidate_chunk
    if C_pad != C:
        head = np.concatenate([head, np.broadcast_to(head[:1], (C_pad - C, *head.shape[1:]))])
        neuron = np.concatenate(
            [neuron, np.broadcast_to(neuron[:1], (C_pad - C, *neuron.shape[1:]))])
    head = torch.as_tensor(head, device=device)
    neuron = torch.as_tensor(neuron, device=device)

    correct = np.zeros(C_pad, dtype=np.int64)
    shard = np.zeros(C_pad, dtype=np.int64)  # counts of this rank's rows only
    total = 0
    batch_size = None
    for images, labels in val_batches:
        images, labels, batch_size, n = pad_batch_to_steady(images, labels, batch_size)
        total += int(n)
        rows = None if layout is None else layout.rows(len(labels))
        images, labels = batch_rows(rows, images, labels)
        images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        if prepare is not None:
            images = prepare(images)
        labels = torch.from_numpy(labels.astype(np.int64)).to(device)
        for c0 in range(0, C_pad, candidate_chunk):
            sl = slice(c0, c0 + candidate_chunk)
            out = step(Gates(head[sl], neuron[sl]), images, labels)
            (correct if rows is None else shard)[sl] += out.cpu().numpy().astype(np.int64)
    if layout is not None:
        correct += layout.sum_over_data(torch.from_numpy(shard).to(device)).cpu().numpy()
    return 100.0 * correct[:C] / max(total, 1)


@dataclasses.dataclass
class ShrinkResult:
    policies: np.ndarray  # (P, 2*layer)
    accuracies: np.ndarray  # (P,)

    @property
    def best(self) -> np.ndarray:
        """The argmax-accuracy policy, the row the distillation stage takes."""
        return self.policies[int(np.argmax(self.accuracies))]


def model_shrink(
    model,
    neuron_rank: np.ndarray,
    head_rank: np.ndarray,
    val_batches_fn: Callable[[], Iterable],
    *,
    layer: int = 12,
    shrink_ratio: float = 0.3,
    population: int = 50,
    lb: float = 0.0,
    ub: float = 0.9,
    # 9.19 is the reference's anchor verbatim. It is the full dedeit GFLOPs
    # (cal_shrink_macs returns flops/2, about 4.6 G), so a shrink_ratio of r
    # keeps about 2r of the true MACs. The default holds for the canonical
    # 12-layer dedeit geometry only; None derives 2x the model's analytic
    # full MACs for any other geometry.
    full_gmacs: Optional[float] = 9.19,
    emb: int = 384,
    head: int = 6,
    seq_length: int = 197,
    mlp_ratio: float = 4,
    candidate_chunk: int = 8,
    seed: Optional[int] = None,
    prepare: Optional[Callable] = None,
    log=None,
    layout=None,
) -> ShrinkResult:
    """End-to-end policy search. `val_batches_fn()` returns a fresh iterable
    of RAW HOST (images, labels) batches; `prepare` is the eval transform
    (see evaluate_policies, which `layout` shards)."""
    if full_gmacs is None:
        zeros = [0.0] * layer
        full_gmacs = 2 * cal_shrink_macs(
            zeros, zeros, emb=emb, mlp_ratio=mlp_ratio, seq_length=seq_length,
            head=head, layer=layer,
        )
    macs_target = shrink_ratio * full_gmacs
    candidates = screen(
        macs_target, population, lb, ub, layer,
        emb=emb, head=head, seq_length=seq_length, mlp_ratio=mlp_ratio, seed=seed, log=log,
    )
    stacked = policies_to_gates(candidates, neuron_rank, head_rank, layer)
    accs = evaluate_policies(
        model, stacked, val_batches_fn(), candidate_chunk=candidate_chunk, prepare=prepare,
        layout=layout,
    )
    if log is not None:
        for ratio, acc in zip(candidates, accs):
            macs = cal_shrink_macs(
                neuron_sparsity=ratio[:layer], head_sparsity=ratio[layer:],
                emb=emb, mlp_ratio=mlp_ratio, seq_length=seq_length, head=head, layer=layer,
            )
            log.info(f"policy MACs={macs:.3f}G acc={acc:.2f}")
    return ShrinkResult(policies=np.array(candidates), accuracies=np.asarray(accs))

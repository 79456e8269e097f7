"""Process layouts and collectives (counterpart of devit_tpu/parallel/mesh.py):
the port's replacement for the JAX package's device meshes.

The JAX package places one SPMD program over a mesh and lets XLA insert the
collectives. The port runs one process per device (runtime.setup_runtime)
and places its collectives itself, explicitly, where it already computes
the gradients (train/steps.py). A Layout names the two axes:

- 'data': batch sharding for every training stage (the reference's DDP).
  A rank computes its rows of the global batch; each state's gradients are
  averaged over the data group in one flattened bucket.
- 'div': the division axis of stage 5. A rank holds its divisions' slices
  of the division-stacked state and computes only them; the (k, b, C)
  division tokens are gathered to (D, b, C) over the division group, and
  every rank of that group runs the same EnsMLP. The global-norm clip of a
  division-sharded state sums its squares over the division group.

Rank r holds division group r // data_n and data shard r % data_n. One
process is a Layout of world 1, whose collectives are no-ops.

Every gather here is an all-reduce (sum) of a zero buffer that holds the
rank's own slice: exact, and one collective the gloo backend takes on CUDA
tensors as well as NCCL, so ranks that share a card run the same code.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from devit_tpu_torch import runtime

DATA_AXIS = "data"
DIV_AXIS = "div"

_GROUPS: Dict[tuple, tuple] = {}


def _groups(world: int, div_n: int, data_n: int):
    """(div groups by data shard, data groups by division group), made once
    per shape. Every rank makes every group, in one order (new_group is a
    collective over the world); a group of one rank is None."""
    key = (world, div_n, data_n)
    if key not in _GROUPS:
        div = [dist.new_group([d * data_n + s for d in range(div_n)]) if div_n > 1 else None
               for s in range(data_n)]
        data = [dist.new_group([d * data_n + s for s in range(data_n)]) if data_n > 1 else None
                for d in range(div_n)]
        _GROUPS[key] = (div, data)
    return _GROUPS[key]


@dataclasses.dataclass
class Layout:
    """A rank's place on the ('div', 'data') grid, and its process groups."""

    world: int
    rank: int
    div_n: int
    data_n: int
    num_divisions: int = 1
    div_group: Optional[object] = None
    data_group: Optional[object] = None
    log: Optional[Callable[[str], None]] = None  # warns once of a replicated batch
    _warned: bool = dataclasses.field(default=False, repr=False)

    @property
    def shape(self) -> dict:
        return {DIV_AXIS: self.div_n, DATA_AXIS: self.data_n}

    @property
    def div_index(self) -> int:
        return self.rank // self.data_n

    @property
    def data_index(self) -> int:
        return self.rank % self.data_n

    @property
    def divisions(self) -> range:
        """The global indices of the divisions this rank holds."""
        per = self.num_divisions // self.div_n
        return range(self.div_index * per, (self.div_index + 1) * per)

    @property
    def division_sharded(self) -> bool:
        return self.div_n > 1

    def rows(self, batch: int) -> Optional[tuple]:
        """This rank's (start, stop, batch) rows of a global batch, or None
        where it computes all of it: one data shard, or a batch the shards
        do not divide (replicated, correct, no speed-up)."""
        if self.data_n == 1:
            return None
        if batch % self.data_n:
            if self.log is not None and not self._warned:
                self._warned = True
                self.log(f"WARNING: batch dim {batch} not divisible by {self.data_n} data "
                         "ranks - computed whole on every rank (no data-parallel speed-up "
                         "for such batches)")
            return None
        b = batch // self.data_n
        return (self.data_index * b, (self.data_index + 1) * b, batch)

    # ---- collectives (no-ops on a group of one)

    def mean_over_data(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor averaged over the data group, in one flattened
        all-reduce bucket (one dtype)."""
        tensors = list(tensors)
        if self.data_group is None or not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        flat.div_(self.data_n)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        if self.data_group is not None:
            t = t.clone()
            dist.all_reduce(t, group=self.data_group)
        return t

    def sum_over_div(self, t: torch.Tensor) -> torch.Tensor:
        if self.div_group is not None:
            t = t.clone()
            dist.all_reduce(t, group=self.div_group)
        return t

    def gather_divisions(self, x: torch.Tensor) -> torch.Tensor:
        """(k, ...) tokens of this rank's divisions -> (D, ...) over the
        division group. Its backward hands each rank the gradient of its own
        slice: every rank of the group runs the same fusion on the same
        rows, so that slice is the whole gradient (summing the group's
        copies would make it div_n times too large)."""
        if self.div_group is None:
            return x
        return _GatherDivisions.apply(x, self)

    def gather_division_leaf(self, x: torch.Tensor) -> torch.Tensor:
        """A (k, ...) division-sharded leaf -> (D, ...), no autograd."""
        if self.div_group is None:
            return x
        with torch.no_grad():
            return _gather(x.detach(), self)


def _gather(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    # 16-bit floats travel as f32 (exact both ways): not every gloo build
    # reduces bfloat16
    sl = layout.divisions
    wide = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    out = torch.zeros((layout.num_divisions,) + tuple(x.shape[1:]), dtype=wide, device=x.device)
    out[sl.start:sl.stop] = x
    dist.all_reduce(out, group=layout.div_group)
    return out.to(x.dtype)


class _GatherDivisions(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.rows = layout.divisions
        return _gather(x, layout)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows.start:ctx.rows.stop], None


def _layout(div_n: int, num_divisions: int) -> Layout:
    world, rank = runtime.world_size(), runtime.rank()
    data_n = world // div_n
    if world == 1:
        return Layout(1, 0, 1, 1, num_divisions)
    div_groups, data_groups = _groups(world, div_n, data_n)
    return Layout(world, rank, div_n, data_n, num_divisions,
                  div_group=div_groups[rank % data_n], data_group=data_groups[rank // data_n])


def data_layout() -> Layout:
    """Every rank on the 'data' axis (the reference's DDP world)."""
    return _layout(1, 1)


def ensemble_layout(num_divisions: int) -> Layout:
    """('div', 'data') for stage 5, by the JAX package's rule: the division
    axis spans num_divisions ranks where the world divides by it (and is at
    least as large), else 1 (every rank holds every division and the batch
    alone is sharded)."""
    return _layout(layout_shape(runtime.world_size(), num_divisions)[DIV_AXIS], num_divisions)


def layout_shape(world: int, num_divisions: int) -> dict:
    """ensemble_layout's {div, data} for a world size, without a group."""
    div = num_divisions if world % num_divisions == 0 and world >= num_divisions else 1
    return {DIV_AXIS: div, DATA_AXIS: world // div}


def forget_groups() -> None:
    """Drop the cached groups (runtime.shutdown, with the process group)."""
    _GROUPS.clear()


def batch_rows(rows: Optional[tuple], *batch) -> tuple:
    """Layout.rows' rows of each global-batch tensor or array (all of it for
    rows None)."""
    return tuple(x if rows is None else x[rows[0]:rows[1]] for x in batch)


def shard_division_tree(tree: Mapping[str, torch.Tensor], layout: Layout) -> dict:
    """Each leaf's leading division axis cut to this rank's divisions, as a
    new leaf (trainable where the input was); other leaves unchanged."""
    if not layout.division_sharded:
        return dict(tree)
    sl = layout.divisions
    out = {}
    for k, x in tree.items():
        if torch.is_tensor(x) and x.ndim >= 1 and x.shape[0] == layout.num_divisions:
            y = x.detach()[sl.start:sl.stop].clone()
            out[k] = y.requires_grad_(x.requires_grad)
        else:
            out[k] = x
    return out


def gather_division_tree(tree: Mapping[str, torch.Tensor], layout: Layout) -> dict:
    """shard_division_tree's inverse, over the division group (a collective:
    every rank calls it)."""
    per = len(layout.divisions)
    return {k: layout.gather_division_leaf(x) if torch.is_tensor(x) and x.ndim >= 1
            and x.shape[0] == per else x for k, x in tree.items()}


def replicate_tree(tree: Mapping[str, torch.Tensor], layout: Layout) -> Mapping:
    """Every tensor broadcast from rank 0 over the world, in place, so every
    rank starts from rank 0's copy."""
    if layout.world > 1:
        with torch.no_grad():
            for x in tree.values():
                if torch.is_tensor(x):
                    dist.broadcast(x.data, src=0)
    return tree


# NOTE on metric sync: the reference all-reduces SmoothedValue counters
# across ranks (dist_utils.py:35-46). Here the train steps average their
# loss metrics over the data group in the gradients' bucket, and the eval
# steps sum their counters over it (train/steps.py), so train/loop.run_eval
# and the loggers see the global values with no further reduction. A batch
# the data shards do not divide is computed whole on every rank and not
# summed, so it counts once.


_SHARDED_OPT_KEYS = ("mu", "nu", "trace")


def shard_state(state, layout: Layout):
    """A TrainState over the division-stacked parameters cut, in place, to
    this rank's divisions: the parameters, the optimizer's moments and the
    EMA; its global-norm clip then sums over the division group. Returns
    the state."""
    if not layout.division_sharded:
        return state
    state.params = shard_division_tree(state.params, layout)
    for k in _SHARDED_OPT_KEYS:
        if k in state.opt_state:
            state.opt_state[k] = shard_division_tree(state.opt_state[k], layout)
    if state.ema_params is not None:
        state.ema_params = shard_division_tree(state.ema_params, layout)
    state.tx.sumsq_reduce = layout.sum_over_div
    return state


def gathered_state(state, layout: Layout):
    """What one process holds of a division-sharded TrainState (parameters,
    optimizer state, EMA over every division), for a checkpoint: a
    collective over the division group. An object with the attributes
    train/state.stage5_tree reads."""
    if not layout.division_sharded:
        return state
    opt = dict(state.opt_state)
    for k in _SHARDED_OPT_KEYS:
        if k in opt:
            opt[k] = gather_division_tree(opt[k], layout)
    ema = None if state.ema_params is None else gather_division_tree(state.ema_params, layout)
    return types.SimpleNamespace(params=gather_division_tree(state.params, layout),
                                 tx=state.tx, opt_state=opt, ema_params=ema, step=state.step)

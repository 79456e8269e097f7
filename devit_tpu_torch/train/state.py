"""Train state (counterpart of devit_tpu/train/state.py): the step count,
the parameters, the optimizer state and an optional EMA copy.

The JAX state is an immutable pytree that each step replaces; this one holds
the model's own parameters and updates them, the optimizer state and the
EMA in place, so no second copy of the weights is made per step.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from devit_tpu_torch import tracing
from devit_tpu_torch.io.bridge import (
    ensmlp_to_jax_params, ensmlp_values_from_jax_params, stacked_vit_to_jax_params,
    stacked_vit_values_from_jax_params, vit_to_jax_params, vit_values_from_jax_params,
)
from devit_tpu_torch.train.optim import Optimizer, ema_update


class TrainState:
    def __init__(self, params: Dict[str, torch.nn.Parameter], tx: Optimizer, *,
                 ema_params: Optional[Dict[str, torch.Tensor]] = None,
                 ema_decay: float = 0.99996):
        self.step = 0
        self.params = params
        self.tx = tx
        self.opt_state = tx.init(params)
        self.ema_params = ema_params
        self.ema_decay = ema_decay

    @classmethod
    def create(cls, model: Union[torch.nn.Module, Mapping[str, torch.Tensor]], tx: Optimizer, *,
               use_ema: bool = False, ema_decay: float = 0.99996) -> "TrainState":
        """State over `model`'s parameters (by their names), or over a
        {name: trainable tensor} dict such as the ensemble's stacked
        divisions."""
        params = (dict(model.named_parameters()) if isinstance(model, torch.nn.Module)
                  else dict(model))
        ema = ({k: p.detach().clone() for k, p in params.items()} if use_ema else None)
        return cls(params, tx, ema_params=ema, ema_decay=ema_decay)

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        """One optimizer update (and EMA update) in place; returns self."""
        with tracing.span("step.optimizer", device=True):
            self.tx.update(grads, self.opt_state, self.params)
            if self.ema_params is not None:
                ema_update(self.ema_params, self.params, self.ema_decay)
        self.step += 1
        return self


# ---- the JAX package's stage-2 checkpoint tree (devit_tpu/cli/stages.py
# save_state and _try_resume): {params, ema_params, opt_state, epoch}

# The entries of the stage-2/4/5 trees below that the JAX package holds on
# the host (numpy: the epoch, the shrink gates); every other entry is its
# device state. An orbax checkpoint records the difference (jax.Array or
# np.ndarray; cli/common.py make_saver), msgpack does not.
HOST_ENTRIES = frozenset({"epoch", "gates"})


def _chain_layout(tx: Optimizer) -> list:
    """The elements of the optax.chain devit_tpu/train/optim.py's
    make_optimizer builds for `tx`, in order: "clip" (clip_by_global_norm,
    an empty state), "adamw" (scale_by_adam, the masked decay, the
    schedule), "decay" (masked add_decayed_weights: adam and the SGD family
    with weight decay), "adam" (scale_by_adam, the schedule), "sgd"
    (trace or identity, the schedule)."""
    out = ["clip"] if tx.clip_grad is not None else []
    if tx.opt == "adamw":
        return out + ["adamw"]
    if tx.weight_decay:
        out.append("decay")
    return out + ["adam" if tx.opt == "adam" else "sgd"]


def opt_state_to_tree(tx: Optimizer, opt_state: dict, to_tree=vit_to_jax_params) -> dict:
    """The port's optimizer state -> the optax state as flax's to_state_dict
    lays it out (tuples as {"0": ..., "1": ...}, named tuples as dicts,
    empty states as {}), moments as trees of the parameters' layout
    (`to_tree`: scan-stacked by default)."""
    count = np.int32(opt_state["count"])
    moments = lambda k: to_tree(opt_state[k])
    adam = lambda: {"count": count, "mu": moments("mu"), "nu": moments("nu")}
    elems = []
    for kind in _chain_layout(tx):
        if kind == "clip":
            elems.append({})
        elif kind == "adamw":
            elems.append({"0": adam(), "1": {"inner_state": {}}, "2": {"count": count}})
        elif kind == "decay":
            elems.append({"inner_state": {}})
        elif kind == "adam":
            elems.append({"0": adam(), "1": {"count": count}})
        else:
            elems.append({"0": {"trace": moments("trace")} if tx.momentum else {},
                          "1": {"count": count}})
    return {str(i): e for i, e in enumerate(elems)}


def opt_state_from_tree(tx: Optimizer, tree: dict, opt_state: dict,
                        values_fn=vit_values_from_jax_params) -> None:
    """The inverse, in place into the port's `opt_state` (tensors keep
    their device and dtype); `values_fn` the inverse of the `to_tree`."""
    moments, count = {}, None
    for i, kind in enumerate(_chain_layout(tx)):
        elem = tree[str(i)]
        if kind in ("adamw", "adam"):
            moments.update(mu=elem["0"]["mu"], nu=elem["0"]["nu"])
            count = elem["0"]["count"]
        elif kind == "sgd":
            if tx.momentum:
                moments["trace"] = elem["0"]["trace"]
            count = elem["1"]["count"]
    opt_state["count"] = int(np.asarray(count))
    with torch.no_grad():
        for key, sub in moments.items():
            vals = values_fn(sub, opt_state[key].keys())
            for name, t in opt_state[key].items():
                t.copy_(torch.from_numpy(vals[name]))


def stage2_tree(state: TrainState, epoch: int) -> dict:
    """The resumable stage-2 checkpoint the JAX package writes every epoch:
    {params, ema_params (None without EMA), opt_state, epoch (int32)}."""
    return {"params": vit_to_jax_params(state.params),
            "ema_params": None if state.ema_params is None else vit_to_jax_params(state.ema_params),
            "opt_state": opt_state_to_tree(state.tx, state.opt_state),
            "epoch": np.int32(epoch)}


def _copy_values(dst: Mapping[str, torch.Tensor], vals: dict) -> None:
    with torch.no_grad():
        for name, t in dst.items():
            t.copy_(torch.from_numpy(np.ascontiguousarray(vals[name])))


def gates_tree(gates) -> dict:
    """Shrink gates as the checkpoints store them: {head, neuron} f32."""
    head, neuron = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                    for a in gates)
    return {"head": head.astype(np.float32), "neuron": neuron.astype(np.float32)}


def stage4_tree(state: TrainState, epoch: int, gates) -> dict:
    """The JAX package's stage-4 (distill) checkpoint: the stage-2 tree with
    the student's shrink gates, {params, ema_params, opt_state, gates, epoch}."""
    tree = stage2_tree(state, epoch)
    return {"params": tree["params"], "ema_params": tree["ema_params"],
            "opt_state": tree["opt_state"], "gates": gates_tree(gates),
            "epoch": tree["epoch"]}


def stage5_tree(bb_state: TrainState, ens_state: TrainState, epoch: int,
                gates=None) -> dict:
    """The JAX package's resumable stage-5 checkpoint
    (devit_tpu/cli/stages.py _ensemble_ckpt_tree): both parameter sets
    (the division-stacked backbones, EnsMLP), both optimizer states, both
    EMA trees, the epoch, and the stacked shrink gates where the backbones
    are gated."""
    bb_ema, ens_ema = bb_state.ema_params, ens_state.ema_params
    tree = {"backbone_params": stacked_vit_to_jax_params(bb_state.params),
            "ens_params": ensmlp_to_jax_params(ens_state.params),
            "bb_opt_state": opt_state_to_tree(bb_state.tx, bb_state.opt_state,
                                              stacked_vit_to_jax_params),
            "ens_opt_state": opt_state_to_tree(ens_state.tx, ens_state.opt_state,
                                               ensmlp_to_jax_params),
            "bb_ema": None if bb_ema is None else stacked_vit_to_jax_params(bb_ema),
            "ens_ema": None if ens_ema is None else ensmlp_to_jax_params(ens_ema),
            "epoch": np.int32(epoch)}
    if gates is not None:
        tree["gates"] = gates_tree(gates)
    return tree


def restore_stage5_tree(bb_state: TrainState, ens_state: TrainState,
                        tree: dict) -> Tuple[TrainState, TrainState, int]:
    """Load a stage-5 checkpoint tree (either package's) into both states in
    place: params, optimizer states where present, EMA where both have it.
    Returns (bb_state, ens_state, start_epoch)."""
    for st, params_key, opt_key, ema_key, values_fn in (
            (bb_state, "backbone_params", "bb_opt_state", "bb_ema",
             stacked_vit_values_from_jax_params),
            (ens_state, "ens_params", "ens_opt_state", "ens_ema",
             ensmlp_values_from_jax_params)):
        _copy_values(st.params, values_fn(tree[params_key], st.params.keys()))
        if st.ema_params is not None and tree.get(ema_key) is not None:
            _copy_values(st.ema_params, values_fn(tree[ema_key], st.ema_params.keys()))
        if tree.get(opt_key) is not None:
            opt_state_from_tree(st.tx, tree[opt_key], st.opt_state, values_fn)
    return bb_state, ens_state, int(np.asarray(tree.get("epoch", -1))) + 1


def restore_stage2_tree(state: TrainState, tree: dict) -> Tuple[TrainState, int]:
    """Load a stage-2 checkpoint tree (either package's) into `state` in
    place, as _try_resume does: params, the EMA and the optimizer state where
    the tree has them; the step count stays. Returns (state, start_epoch)."""
    with torch.no_grad():
        vals = vit_values_from_jax_params(tree["params"], state.params.keys())
        for name, p in state.params.items():
            p.copy_(torch.from_numpy(vals[name]))
        if state.ema_params is not None and tree.get("ema_params") is not None:
            vals = vit_values_from_jax_params(tree["ema_params"], state.ema_params.keys())
            for name, e in state.ema_params.items():
                e.copy_(torch.from_numpy(vals[name]))
    if tree.get("opt_state") is not None:
        opt_state_from_tree(state.tx, tree["opt_state"], state.opt_state)
    return state, int(np.asarray(tree.get("epoch", -1))) + 1

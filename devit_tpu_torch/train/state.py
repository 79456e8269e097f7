"""Train state (counterpart of devit_tpu/train/state.py): the step count,
the parameters, the optimizer state and an optional EMA copy.

The JAX state is an immutable pytree that each step replaces; this one holds
the model's own parameters and updates them, the optimizer state and the
EMA in place, so no second copy of the weights is made per step.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

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
        self.tx.update(grads, self.opt_state, self.params)
        if self.ema_params is not None:
            ema_update(self.ema_params, self.params, self.ema_decay)
        self.step += 1
        return self

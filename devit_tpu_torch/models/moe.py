"""V-MoE's sparse-expert MLP half (Riquelme et al., "Scaling Vision with
Sparse Mixture of Experts", NeurIPS 2021, arXiv:2106.05974, §2 and
Appendix A): a noisy top-k router, expert capacity, the dispatch of tokens
into per-expert buffers, batched expert MLPs, the weighted combine, and the
two auxiliary losses.

A MoE layer (ViTConfig.moe_layers) replaces the MLP half of a pre-norm
block; the attention half, the LayerNorms, drop-path and the residual adds
are the dense block's. With h = LN2(x) over the group of T = B * N tokens
(one group: the batch on this device), E experts, K choices a token and
sigma = 1 / E:

    logits = h W_r                    W_r (C, E), no bias, in f32
    noisy  = logits + eps             eps ~ N(0, sigma^2) in training,
                                      0 in eval
    gates  = softmax(noisy)           over the E experts, f32
    choice[t, 0..K-1] = the K largest noisy[t] (ties to the lower index)
    w[t, j] = gates[t, choice[t, j]]  (not renormalised over the K)

Capacity: cap = round(K * T * capacity_ratio / E). The choices are ranked
all first choices in token order, then all second choices, ...; a choice's
position is the number of earlier-ranked choices of the same expert, and a
choice at position >= cap is dropped: it contributes nothing.

Expert e is a ViT MLP, fc2_e(GELU(fc1_e(u)) * neuron_gate) with biases; the
output is y[t] = sum over the kept choices of w[t, j] MLP_choice(h[t]),
then x = x + drop_path(y).

Auxiliary losses, per layer, over the group (std the population std):
    imp_e  = sum_t gates[t, e]                L_imp  = (std(imp) / mean(imp))^2
    thr_t  = noisy[t, choice[t, K-1]]         (the K-th largest)
    p[t,e] = 1 - Phi((thr_t - logits[t, e]) / sigma)
    load_e = sum_t p[t, e]                    L_load = (std(load) / mean(load))^2
    aux    = (L_imp + L_load) / 2
gradients flowing through both; the model's aux_loss is the mean of aux
over its MoE layers, and the training loss adds aux_loss_weight times it.

The noise comes from one seed a layer that VisionTransformer's train_draws
draws on the host; the layer draws eps on its own device from that seed,
so remat's recompute draws the same bits. Routing runs in torch ops; the
dispatch and combine are the kernels of kernels/moe.py through the autograd
functions below, the expert GEMMs `torch.baddbmm` over the (E, cap, .)
buffers, whose slots past an expert's fill are zero rows, computed and
never combined.

Spans (tracing.span, device=True): `moe.route`, `moe.dispatch`,
`moe.experts`, `moe.combine`, in the forward and in remat's recompute.
Counters, kept on the device and read once (`route_counts`): a layer's
token-choices routed, dropped, and routed to each expert, counted in every
forward but not in remat's recompute. Each MoE block holds its own
(`RouteLog`), which can also keep the layer's routing (`capture_routing`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from devit_tpu_torch import tracing
from devit_tpu_torch.kernels.moe import moe_combine, moe_combine_dw, moe_gather


def capacity(tokens: int, k: int, experts: int, ratio: float) -> int:
    """Slots an expert holds in a group of `tokens` tokens."""
    return int(round(k * tokens * ratio / experts))


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(T, k) int64: the indices of each row's k largest scores, largest
    first, a tie going to the lower index (argmax's first maximum)."""
    out, s = [], scores
    for _ in range(k):
        i = s.argmax(dim=-1, keepdim=True)
        out.append(i)
        s = s.scatter(-1, i, float("-inf"))
    return torch.cat(out, dim=-1)


def slot_maps(choice: torch.Tensor, experts: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tok_slot (T, K) int32, slot_tok (E * cap,) int32, routed to each
    expert (E,) int64) of `choice` (T, K) under the capacity rule (module
    docstring); -1 marks a dropped choice and an empty slot."""
    T, K = choice.shape
    dev = choice.device
    flat = choice.t().reshape(-1)  # first choices in token order, then second, ...
    # a choice's position: its rank among its expert's choices, from a stable
    # sort by expert (a cumsum down the (K T, E) one-hot took ~9 ms a call on
    # the card at K T 50,432, E 32)
    order = torch.sort(flat, stable=True).indices
    routed = torch.zeros(experts, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    starts = torch.cumsum(routed, 0) - routed
    ranked = torch.arange(K * T, device=dev) - starts[flat[order]]
    position = torch.empty_like(flat).scatter_(0, order, ranked)
    kept = position < cap
    S = experts * cap
    slot = torch.where(kept, flat * cap + position, S)  # S: a dropped choice's dummy slot
    tok_slot = torch.where(kept, slot, -1).to(torch.int32).view(K, T).t().contiguous()
    tokens = torch.arange(T, device=dev, dtype=torch.int32).repeat(K)
    slot_tok = torch.full((S + 1,), -1, dtype=torch.int32, device=dev)
    slot_tok.scatter_(0, slot, tokens)  # one writer a real slot; the dummy is cut off
    return tok_slot, slot_tok[:S], routed


def route(x: torch.Tensor, router_kernel: torch.Tensor, k: int, seed: Optional[int],
          sigma: float, train: bool):
    """(logits, noisy, gates, choice) of the router on x (T, C): the f32
    logits, the noise of `seed` added in training (none where seed is None),
    the softmax gates and the top-k choice of the noisy logits."""
    logits = torch.matmul(x.float(), router_kernel.float())
    noisy = logits
    if train and seed is not None:
        g = torch.Generator(device=x.device).manual_seed(seed)
        noisy = logits + torch.randn(logits.shape, generator=g, device=x.device) * sigma
    return logits, noisy, torch.softmax(noisy, dim=-1), top_k(noisy.detach(), k)


def _cv_squared(v: torch.Tensor) -> torch.Tensor:
    return (v.std(unbiased=False) / v.mean()) ** 2


def aux_loss(logits: torch.Tensor, noisy: torch.Tensor, gates: torch.Tensor,
             choice: torch.Tensor, sigma: float) -> torch.Tensor:
    """(L_imp + L_load) / 2 of one layer (module docstring)."""
    thr = noisy.gather(1, choice[:, -1:])
    p = torch.special.ndtr((logits - thr) / sigma)  # 1 - Phi((thr - logits) / sigma)
    return 0.5 * (_cv_squared(gates.sum(0)) + _cv_squared(p.sum(0)))


class _Dispatch(torch.autograd.Function):
    """buf (S, C) = the gather of x (T, C) by slot_tok; its backward is the
    combine of the slots' gradients with weight 1."""

    @staticmethod
    def forward(ctx, x, tok_slot, slot_tok):
        ctx.save_for_backward(tok_slot)
        return moe_gather(x, slot_tok)

    @staticmethod
    def backward(ctx, dbuf):
        (tok_slot,) = ctx.saved_tensors
        return moe_combine(dbuf.contiguous(), tok_slot), None, None


class _Combine(torch.autograd.Function):
    """y (T, C) = sum_j w[t, j] buf[slot(t, j)]; the backward gathers
    w * dy into the slots and takes dw as the dot of dy with each row."""

    @staticmethod
    def forward(ctx, buf, w, tok_slot, slot_tok):
        ctx.save_for_backward(buf, w, tok_slot, slot_tok)
        return moe_combine(buf, tok_slot, w)

    @staticmethod
    def backward(ctx, dy):
        buf, w, tok_slot, slot_tok = ctx.saved_tensors
        dy = dy.contiguous()
        dbuf = moe_gather(dy, slot_tok, tok_slot, w) if ctx.needs_input_grad[0] else None
        dw = moe_combine_dw(dy, buf, tok_slot) if ctx.needs_input_grad[1] else None
        return dbuf, dw, None, None


def dispatch(x: torch.Tensor, tok_slot: torch.Tensor, slot_tok: torch.Tensor) -> torch.Tensor:
    return _Dispatch.apply(x, tok_slot, slot_tok)


def combine(buf: torch.Tensor, w: torch.Tensor, tok_slot: torch.Tensor,
            slot_tok: torch.Tensor) -> torch.Tensor:
    return _Combine.apply(buf, w, tok_slot, slot_tok)


class StackedDense(nn.Module):
    """E dense layers side by side: kernel (E, in, out), bias (E, out), the
    (in, out) layout of `Dense`, cast to the compute dtype for the product."""

    def __init__(self, experts: int, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(experts, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(experts, out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.baddbmm(self.bias.to(dtype)[:, None, :], x.to(dtype), self.kernel.to(dtype))


class Experts(nn.Module):
    """E ViT MLPs over (E, cap, C) slot buffers."""

    def __init__(self, experts: int, dim: int, hidden: int):
        super().__init__()
        self.fc1 = StackedDense(experts, dim, hidden)
        self.fc2 = StackedDense(experts, hidden, dim)

    def forward(self, buf: torch.Tensor, neuron_gate: torch.Tensor, dtype: torch.dtype,
                gelu: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        h = gelu(self.fc1(buf, dtype))
        return self.fc2(h * neuron_gate.to(dtype), dtype)


class RouteLog:
    """A MoE layer's counters on its device: token-choices routed, dropped,
    and routed to each expert (before capacity); and, while `capture` is a
    dict, the layer's latest (input h, choice) under its index."""

    def __init__(self):
        self.routed = self.dropped = self.per_expert = None
        self.capture: Optional[dict] = None

    def add(self, per_expert: torch.Tensor, cap: int) -> None:
        if self.per_expert is None or self.per_expert.device != per_expert.device:
            zero = torch.zeros((), dtype=torch.int64, device=per_expert.device)
            self.routed, self.dropped = zero.clone(), zero.clone()
            self.per_expert = torch.zeros_like(per_expert)
        self.routed.add_(per_expert.sum())
        self.dropped.add_((per_expert - per_expert.clamp(max=cap)).sum())
        self.per_expert.add_(per_expert)


def _in_backward() -> bool:
    """True inside a backward pass, where remat recomputes a block."""
    return torch._C._current_graph_task_id() != -1


def _logs(model: nn.Module):
    return [(i, blk.route_log) for i, blk in enumerate(getattr(model, "blocks", []))
            if getattr(blk, "moe", False)]


@contextlib.contextmanager
def capture_routing(model: nn.Module):
    """Inside the block, every forward of the model's MoE layers (not
    remat's recompute) stores {layer index: (its (T, C) input h, choice
    (T, K))} in the yielded dict, the latest call of each layer: what a
    check of the routing against a reference reads."""
    out: dict = {}
    logs = [log for _, log in _logs(model)]
    for log in logs:
        log.capture = out
    try:
        yield out
    finally:
        for log in logs:
            log.capture = None


def moe_mlp(h: torch.Tensor, router_kernel: torch.Tensor, experts: Experts,
            log: RouteLog, *, layer: int, num_experts: int, k: int, ratio: float,
            neuron_gate: torch.Tensor, seed: Optional[int], train: bool, dtype: torch.dtype,
            gelu: Callable[[torch.Tensor], torch.Tensor]
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE half on h = LN2(x) (B, N, C): (y (B, N, C), the layer's aux
    loss in training, else None). `seed` seeds the router noise (training
    only; None: no noise)."""
    if neuron_gate.dim() != 1:
        raise ValueError("a MoE layer takes one neuron gate for the whole batch")
    B, N, C = h.shape
    T, E = B * N, num_experts
    cap = capacity(T, k, E, ratio)
    sigma = 1.0 / E
    x = h.reshape(T, C)
    with tracing.span("moe.route", device=True):
        logits, noisy, gates, choice = route(x, router_kernel, k, seed, sigma, train)
        w = gates.gather(1, choice)
        tok_slot, slot_tok, per_expert = slot_maps(choice, E, cap)
        aux = aux_loss(logits, noisy, gates, choice, sigma) if train else None
        if not _in_backward():
            log.add(per_expert, cap)
            if log.capture is not None:
                log.capture[layer] = (x.detach(), choice)
    with tracing.span("moe.dispatch", device=True):
        buf = dispatch(x, tok_slot, slot_tok)
    with tracing.span("moe.experts", device=True):
        out = experts(buf.view(E, cap, C), neuron_gate, dtype, gelu)
    with tracing.span("moe.combine", device=True):
        y = combine(out.view(E * cap, C), w, tok_slot, slot_tok)
    return y.view(B, N, C), aux


def route_counts(model: nn.Module) -> Dict[int, dict]:
    """{layer index: {"routed", "dropped", "per_expert"}} of the model's MoE
    layers, brought to the host in one copy (zeros before any forward)."""
    layers = _logs(model)
    live = [(i, c) for i, c in layers if c.per_expert is not None]
    out = {i: {"routed": 0, "dropped": 0, "per_expert": []} for i, _ in layers}
    if live:
        flat = torch.cat([torch.cat([c.routed[None], c.dropped[None], c.per_expert])
                          for _, c in live]).cpu().tolist()
        pos = 0
        for i, c in live:
            E = c.per_expert.numel()
            out[i] = {"routed": flat[pos], "dropped": flat[pos + 1],
                      "per_expert": flat[pos + 2:pos + 2 + E]}
            pos += 2 + E
    return out


def reset_route_counts(model: nn.Module) -> None:
    for _, log in _logs(model):
        log.routed = log.dropped = log.per_expert = None

